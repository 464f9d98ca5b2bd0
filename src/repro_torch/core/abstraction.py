"""CIM hardware abstraction (Abs-arch) and computing modes (Abs-com).

Reproduces §3.2 of CIM-MLC (ASPLOS'24): a three-tier architecture
abstraction — chip / core / crossbar — each tier carrying the parameter
table of Figures 5, 6 and 8, plus the three computing-mode abstractions
(CM / XBM / WLM) that determine which scheduling levels the compiler may
exercise (§3.2.1-3.2.3).

All presets from the paper's evaluation are provided:
  * ``isaac_baseline``  — Table 3 (ISAAC-like ReRAM chip, XBM+WLM capable)
  * ``jia_cm``          — Figure 17 (Jia et al. ISSCC'21 SRAM chip, CM)
  * ``puma_xbm``        — Figure 18 (PUMA ReRAM chip, XBM)
  * ``jain_wlm``        — Figure 19 (Jain et al. JSSC'21 SRAM macro, WLM)
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class ComputingMode(enum.Enum):
    """Abs-com: the scheduling granularity the chip exposes (§3.2).

    CM  — core mode:      whole cores execute whole DNN operators.
    XBM — crossbar mode:   individual crossbars execute MVMs.
    WLM — wordline mode:   individual row groups can be activated.

    The modes are ordered coarse→fine; a chip exposing WLM also allows the
    scheduler to use the coarser levels (the paper's multi-level joint
    scheduling inherits coarse results into finer passes).
    """

    CM = "CM"
    XBM = "XBM"
    WLM = "WLM"

    @property
    def rank(self) -> int:
        return {"CM": 0, "XBM": 1, "WLM": 2}[self.value]

    def allows(self, other: "ComputingMode") -> bool:
        """True if a chip in mode ``self`` permits scheduling level ``other``."""
        return other.rank <= self.rank


class CellType(enum.Enum):
    SRAM = "SRAM"
    RERAM = "ReRAM"
    FLASH = "FLASH"
    PCM = "PCM"

    @property
    def write_cost_per_row(self) -> float:
        """Relative cycles to (re)program one crossbar row.

        Captures the paper's §1 observation: SRAM supports flexible
        updates while ReRAM/FLASH writes are expensive, so schedulers for
        those devices avoid weight rewrites (this is what penalises graph
        segmentation on ReRAM chips — see cg_opt.segment_graph).
        """
        return {
            "SRAM": 1.0,
            "ReRAM": 100.0,
            "FLASH": 1000.0,
            "PCM": 150.0,
        }[self.value]


@dataclasses.dataclass(frozen=True)
class ChipTier:
    """Figure 5 — chip-tier architecture abstraction parameters."""

    core_number: Tuple[int, int]        # cores per row * cores per column
    alu_ops_per_cycle: float = math.inf  # "ALU": digital compute capacity
    core_noc: str = "mesh"               # NoC type
    core_noc_cost: float = 0.0           # cycles per bit between adjacent cores
    l0_size_kb: float = math.inf         # global buffer capacity
    l0_bw_bits: float = math.inf         # global buffer bandwidth, bits/cycle

    @property
    def n_cores(self) -> int:
        return self.core_number[0] * self.core_number[1]


@dataclasses.dataclass(frozen=True)
class CoreTier:
    """Figure 6 — core-tier architecture abstraction parameters."""

    xb_number: Tuple[int, int]           # crossbars per row * per column
    alu_ops_per_cycle: float = math.inf
    xb_noc: str = "shared-bus"
    xb_noc_cost: float = 0.0
    l1_size_kb: float = math.inf
    l1_bw_bits: float = math.inf

    @property
    def n_xbs(self) -> int:
        return self.xb_number[0] * self.xb_number[1]


@dataclasses.dataclass(frozen=True)
class CrossbarTier:
    """Figure 8 — crossbar-tier architecture abstraction parameters."""

    xb_size: Tuple[int, int]             # rows (wordlines) * columns (bitlines)
    dac_bits: int = 1                    # DAC precision
    adc_bits: int = 8                    # ADC precision
    cell_type: CellType = CellType.RERAM
    cell_precision: int = 2              # bits stored per cell
    parallel_row: Optional[int] = None   # max simultaneously-activated rows

    def __post_init__(self):
        if self.parallel_row is None:
            object.__setattr__(self, "parallel_row", self.xb_size[0])
        if self.parallel_row <= 0:
            raise ValueError("parallel_row must be positive")
        if self.cell_precision <= 0:
            raise ValueError("cell_precision must be positive")

    @property
    def rows(self) -> int:
        return self.xb_size[0]

    @property
    def cols(self) -> int:
        return self.xb_size[1]

    @property
    def cells(self) -> int:
        return self.rows * self.cols

    def row_groups(self, rows_used: int) -> int:
        """Serial activation groups needed to read ``rows_used`` wordlines."""
        rows_used = min(rows_used, self.rows)
        return max(1, math.ceil(rows_used / self.parallel_row))

    def input_phases(self, act_bits: int) -> int:
        """Bit-serial DAC phases to present an ``act_bits`` input."""
        return max(1, math.ceil(act_bits / self.dac_bits))


@dataclasses.dataclass(frozen=True)
class CIMArch:
    """A complete Abs-arch + Abs-com description of one CIM accelerator."""

    name: str
    mode: ComputingMode
    chip: ChipTier
    core: CoreTier
    xb: CrossbarTier
    act_bits: int = 8                    # activation precision of the workload
    weight_bits: int = 8                 # weight precision of the workload

    # ---- derived capacities --------------------------------------------
    @property
    def col_slices(self) -> int:
        """Columns per logical weight (bit-slicing B -> adjacent XBC)."""
        return math.ceil(self.weight_bits / self.xb.cell_precision)

    @property
    def core_weight_capacity_bits(self) -> float:
        """Weight bits one core can hold across its crossbars."""
        return self.core.n_xbs * self.xb.cells * self.xb.cell_precision

    @property
    def chip_weight_capacity_bits(self) -> float:
        return self.chip.n_cores * self.core_weight_capacity_bits

    # ---- elementary latencies (cycles) ---------------------------------
    def t_xb_read(self, rows_used: Optional[int] = None) -> int:
        """Cycles for one crossbar activation (one analog MVM read).

        = input-bit phases x serial row groups. In XBM (no wordline
        control) the whole array is activated, so rows_used is the full
        row count unless the arch exposes WLM.
        """
        if rows_used is None or not self.mode.allows(ComputingMode.WLM):
            rows_used = self.xb.rows
        return self.xb.input_phases(self.act_bits) * self.xb.row_groups(rows_used)

    def t_write_xb(self) -> float:
        """Cycles to program one full crossbar (row-by-row write)."""
        return self.xb.rows * self.xb.cell_type.write_cost_per_row

    def replace(self, **kw) -> "CIMArch":
        return dataclasses.replace(self, **kw)

    def subarch(self, n_cores: int, name: Optional[str] = None) -> "CIMArch":
        """A crossbar-budget *view* of this chip: the same core and
        crossbar tiers, but only ``n_cores`` of the chip's cores.

        This is how the multi-tenant tenancy planner
        (``serving.placement``) hands each co-resident model a feasible
        slice of the physical crossbar pool: every compiler pass and the
        executor see an ordinary ``CIMArch`` whose capacity is the
        tenant's partition, so per-tenant compiles can never place
        weights outside their budget.  Chip-shared resources (ALU rate,
        L0 bandwidth, NoC cost) are intentionally left at chip scale —
        partitioning them is traffic-dependent, not capacity-dependent.
        """
        if not 1 <= n_cores <= self.chip.n_cores:
            raise ValueError(
                f"subarch needs 1 <= n_cores <= {self.chip.n_cores}, "
                f"got {n_cores}")
        chip = dataclasses.replace(self.chip, core_number=(n_cores, 1))
        return self.replace(chip=chip,
                            name=name or f"{self.name}[{n_cores}c]")

    # ---- stable serialization (compile-cache keys, sweep manifests) ----
    def to_dict(self) -> dict:
        """JSON-safe, order-stable description of the full Abs-arch +
        Abs-com configuration.  Two archs with equal ``to_dict()`` compile
        identically, so this is the arch half of a compile-cache key."""
        d = dataclasses.asdict(self)
        d["mode"] = self.mode.value
        d["xb"]["cell_type"] = self.xb.cell_type.value
        return d

    def fingerprint(self) -> str:
        """Stable hex digest of ``to_dict()`` (content-addressed caching)."""
        import hashlib
        import json
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Presets from the paper's evaluation section.
# ---------------------------------------------------------------------------

def isaac_baseline(**overrides) -> CIMArch:
    """Table 3 — ISAAC-like ReRAM baseline used in §4.2-§4.4.

    1024 cores, 8 crossbars per core (ISAAC: 8 arrays per IMA), 128x128
    ReRAM arrays with 2-bit cells, 1-bit DAC / 8-bit ADC, 8 parallel rows.
    """
    arch = CIMArch(
        name="isaac-baseline",
        mode=ComputingMode.WLM,
        chip=ChipTier(core_number=(32, 32), alu_ops_per_cycle=1024,
                      l0_bw_bits=8192),
        core=CoreTier(xb_number=(2, 4), alu_ops_per_cycle=1024,
                      l1_bw_bits=8192),
        xb=CrossbarTier(xb_size=(128, 128), dac_bits=1, adc_bits=8,
                        cell_type=CellType.RERAM, cell_precision=2,
                        parallel_row=8),
    )
    return arch.replace(**overrides) if overrides else arch


def jia_cm(**overrides) -> CIMArch:
    """Figure 17 — Jia et al. ISSCC'21: 16 CIMUs of 1152x256 SRAM, CM mode.

    High-precision ADC allows all 1152 rows in parallel; the chip only
    exposes core-granularity activation -> the compiler may use CG-grained
    scheduling only.
    """
    arch = CIMArch(
        name="jia-issc21",
        mode=ComputingMode.CM,
        chip=ChipTier(core_number=(4, 4), core_noc="disjoint-buffer-switch"),
        core=CoreTier(xb_number=(1, 1)),
        xb=CrossbarTier(xb_size=(1152, 256), dac_bits=1, adc_bits=8,
                        cell_type=CellType.SRAM, cell_precision=1,
                        parallel_row=1152),
    )
    return arch.replace(**overrides) if overrides else arch


def puma_xbm(**overrides) -> CIMArch:
    """Figure 18 — PUMA: 138 cores x 2 crossbars of 128x128 ReRAM, XBM mode."""
    arch = CIMArch(
        name="puma",
        mode=ComputingMode.XBM,
        chip=ChipTier(core_number=(138, 1), core_noc="mesh",
                      l0_size_kb=96, l0_bw_bits=384),
        core=CoreTier(xb_number=(2, 1), l1_size_kb=1),
        xb=CrossbarTier(xb_size=(128, 128), dac_bits=8, adc_bits=1,
                        cell_type=CellType.RERAM, cell_precision=2,
                        parallel_row=128),
    )
    return arch.replace(**overrides) if overrides else arch


def jain_wlm(**overrides) -> CIMArch:
    """Figure 19 — Jain et al. JSSC'21 SRAM macro: 4 cores x 2 crossbars of
    256x64, only <=32 rows active at once -> WLM mode."""
    arch = CIMArch(
        name="jain-jssc21",
        mode=ComputingMode.WLM,
        chip=ChipTier(core_number=(4, 1)),
        core=CoreTier(xb_number=(2, 1)),
        xb=CrossbarTier(xb_size=(256, 64), dac_bits=1, adc_bits=6,
                        cell_type=CellType.SRAM, cell_precision=1,
                        parallel_row=32),
    )
    return arch.replace(**overrides) if overrides else arch


def toy_example(**overrides) -> CIMArch:
    """Table 2 — the §3.4 walk-through architecture: 2 cores x 2 crossbars
    of 32x128 with 2-bit cells, 16 parallel rows."""
    arch = CIMArch(
        name="toy-section-3.4",
        mode=ComputingMode.WLM,
        chip=ChipTier(core_number=(2, 1)),
        core=CoreTier(xb_number=(2, 1)),
        xb=CrossbarTier(xb_size=(32, 128), dac_bits=8, adc_bits=8,
                        cell_type=CellType.SRAM, cell_precision=2,
                        parallel_row=16),
    )
    return arch.replace(**overrides) if overrides else arch


PRESETS = {
    "isaac-baseline": isaac_baseline,
    "jia-issc21": jia_cm,
    "puma": puma_xbm,
    "jain-jssc21": jain_wlm,
    "toy": toy_example,
}


def get_arch(name: str, **overrides) -> CIMArch:
    if name not in PRESETS:
        raise KeyError(f"unknown CIM arch preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**overrides)
