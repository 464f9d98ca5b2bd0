"""The cross-tier knob space (§4.3-§4.4 made enumerable).

A ``DesignPoint`` is one compiler configuration: the scheduling level,
the bit-dimension binding, the two CG switches, plus a tuple of Abs-arch
parameter overrides addressed by dotted path (``"xb.cell_precision"``,
``"chip.core_number"``, ...).  ``DesignSpace.points()`` takes the cross
product of all axes and keeps only the *valid* points:

  * the level is clamped to what the (possibly overridden) chip's
    computing mode allows — a CM chip never yields XBM/WLM points — and
    duplicate clamped points collapse;
  * ``B->XBC`` binding requires the crossbar to have at least
    ``ceil(weight_bits / cell_precision)`` columns (mapping.bind raises
    otherwise), so infeasible combinations are filtered out up front.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

from ..core.abstraction import CIMArch, ComputingMode
from ..core.mapping import BitBinding

#: tier dataclass fields reachable through a dotted override path
_TIERS = ("chip", "core", "xb")


def apply_arch_overrides(arch: CIMArch,
                         overrides: Mapping[str, Any]) -> CIMArch:
    """Return ``arch`` with dotted-path parameter overrides applied.

    Top-level fields use their bare name (``"act_bits"``); tier fields
    use ``"<tier>.<field>"`` (``"xb.xb_size"``).  Shrinking ``xb.xb_size``
    below the current ``parallel_row`` clamps ``parallel_row`` to the new
    row count instead of producing an unbuildable tier.
    """
    per_tier: Dict[str, Dict[str, Any]] = {t: {} for t in _TIERS}
    top: Dict[str, Any] = {}
    for path, value in overrides.items():
        if "." in path:
            tier, field = path.split(".", 1)
            if tier not in per_tier:
                raise KeyError(f"unknown arch tier {tier!r} in {path!r}")
            per_tier[tier][field] = value
        else:
            top[path] = value
    for tier, kw in per_tier.items():
        if not kw:
            continue
        cur = getattr(arch, tier)
        if tier == "xb":
            rows = kw.get("xb_size", cur.xb_size)[0]
            pr = kw.get("parallel_row", cur.parallel_row)
            kw.setdefault("parallel_row", min(pr, rows))
        top[tier] = dataclasses.replace(cur, **kw)
    return arch.replace(**top) if top else arch


def _as_mode(level: Union[str, ComputingMode]) -> ComputingMode:
    return level if isinstance(level, ComputingMode) else ComputingMode(level)


def _as_binding(b: Union[str, BitBinding]) -> BitBinding:
    return b if isinstance(b, BitBinding) else BitBinding(b)


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One compiler configuration of the sweep (hashable, picklable)."""

    level: str                  # ComputingMode value
    binding: str                # BitBinding value
    use_pipeline: bool
    use_duplication: bool
    arch_overrides: Tuple[Tuple[str, Any], ...] = ()

    @property
    def mode(self) -> ComputingMode:
        return ComputingMode(self.level)

    @property
    def bit_binding(self) -> BitBinding:
        return BitBinding(self.binding)

    def arch_for(self, base: CIMArch) -> CIMArch:
        return apply_arch_overrides(base, dict(self.arch_overrides))

    def compile_kwargs(self) -> Dict[str, Any]:
        return dict(level=self.mode, binding=self.bit_binding,
                    use_pipeline=self.use_pipeline,
                    use_duplication=self.use_duplication)

    def label(self) -> str:
        knobs = [self.level, self.binding,
                 "pipe" if self.use_pipeline else "nopipe",
                 "dup" if self.use_duplication else "nodup"]
        knobs += [f"{k}={v}" for k, v in self.arch_overrides]
        return " ".join(str(k) for k in knobs)


@dataclasses.dataclass
class DesignSpace:
    """Cartesian knob space around a base architecture."""

    arch: CIMArch
    levels: Sequence[Union[str, ComputingMode]] = ("CM", "XBM", "WLM")
    bindings: Sequence[Union[str, BitBinding]] = (
        BitBinding.B_TO_XBC, BitBinding.B_TO_XB)
    pipeline: Sequence[bool] = (True, False)
    duplication: Sequence[bool] = (True, False)
    #: dotted arch path -> candidate values, e.g.
    #: {"xb.xb_size": [(128, 128), (256, 256)], "xb.cell_precision": [1, 2]}
    arch_axes: Mapping[str, Sequence[Any]] = dataclasses.field(
        default_factory=dict)

    def arch_variants(self) -> List[Tuple[Tuple[Tuple[str, Any], ...], CIMArch]]:
        """(overrides, concrete arch) per point of the arch sub-space."""
        axes = [(path, list(values)) for path, values in self.arch_axes.items()]
        out = []
        for combo in itertools.product(*(vals for _, vals in axes)):
            ov = tuple((path, val)
                       for (path, _), val in zip(axes, combo))
            out.append((ov, apply_arch_overrides(self.arch, dict(ov))))
        return out

    def points(self) -> List[DesignPoint]:
        """All valid points, deduplicated after mode clamping."""
        pts: List[DesignPoint] = []
        seen = set()
        for overrides, arch in self.arch_variants():
            slices = math.ceil(arch.weight_bits / arch.xb.cell_precision)
            for lvl, bnd, pipe, dup in itertools.product(
                    self.levels, self.bindings, self.pipeline,
                    self.duplication):
                mode = _as_mode(lvl)
                if mode.rank > arch.mode.rank:
                    mode = arch.mode          # clamp to the chip's mode
                binding = _as_binding(bnd)
                if binding is BitBinding.B_TO_XBC and arch.xb.cols < slices:
                    continue                  # bit slices cannot share a xb
                pt = DesignPoint(level=mode.value, binding=binding.value,
                                 use_pipeline=pipe, use_duplication=dup,
                                 arch_overrides=overrides)
                if pt in seen:
                    continue
                seen.add(pt)
                pts.append(pt)
        return pts

    def __len__(self) -> int:
        return len(self.points())
