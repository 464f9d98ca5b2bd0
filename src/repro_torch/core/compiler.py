"""Multi-level scheduling driver (§3.3.1, Figure 3).

The computing mode exposed by the target chip selects the pass stack:

    CM  chip:  CG-grained only
    XBM chip:  CG-grained -> MVM-grained
    WLM chip:  CG-grained -> MVM-grained -> VVM-grained

Finer passes inherit the coarser results (the paper's "multi-level joint
scheduling").  ``level`` may be clamped below the chip's mode for the
ablation arms of §4.3 (e.g. evaluate CG-only on a WLM-capable chip).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional, Union

from ..obs import hooks as obs_hooks
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import cg_opt, codegen, mvm_opt, vvm_opt
from .abstraction import CIMArch, ComputingMode
from .cg_opt import SchedulePlan
from .graph import Graph
from .mapping import BitBinding
from .mop import Program


@dataclasses.dataclass
class CompileResult:
    plan: SchedulePlan
    program: Program
    #: content hash of the (graph, arch, knobs) config that produced this
    #: result, as stored in the compile cache.  Note the executor cache
    #: derives its own key via ``compile_key_for_plan`` (normalized over
    #: expansion and salted by baseline policy) — this field is identity
    #: metadata, not that anchor.
    key: Optional[str] = None

    @property
    def text(self) -> str:
        return self.program.to_text()

    def report(self) -> dict:
        from ..cimsim import perf
        return dataclasses.asdict(perf.estimate(self.plan))

    def metrics(self) -> dict:
        """JSON-safe metric bundle (the DSE objective vector lives here)."""
        from ..cimsim import perf
        return perf.estimate(self.plan).metrics()


# ---------------------------------------------------------------------------
# Compile cache hook.
#
# ``compile_graph`` consults an (optional) cache object with the duck-typed
# interface ``get(key) -> Optional[CompileResult]`` / ``put(key, result)``
# (dse.cache.CompileCache is the disk-backed implementation).  The key is a
# content hash of everything that determines the output: the graph structure,
# the full Abs-arch description and every scheduling knob.
# ---------------------------------------------------------------------------

#: bump when compiler passes change in ways that alter emitted programs
#: (or when CompileResult's pickled layout changes), so stale cache
#: entries from older code can never be returned.
COMPILE_KEY_SCHEMA = 2

_COMPILE_CACHE = None


def set_compile_cache(cache):
    """Install a process-wide default compile cache; returns the previous
    one (``None`` to disable).  Explicit ``compile_graph(..., cache=...)``
    arguments take precedence."""
    global _COMPILE_CACHE
    prev, _COMPILE_CACHE = _COMPILE_CACHE, cache
    return prev


def get_compile_cache():
    return _COMPILE_CACHE


def compile_key(
    graph: Graph,
    arch: CIMArch,
    *,
    level: Optional[Union[str, ComputingMode]] = None,
    use_pipeline: bool = True,
    use_duplication: bool = True,
    binding: BitBinding = BitBinding.B_TO_XBC,
    expand: bool = False,
) -> str:
    """Stable content hash of one (graph, arch, knobs) compile config."""
    if isinstance(level, str):
        level = ComputingMode(level)
    level = level or arch.mode
    payload = {
        "schema": COMPILE_KEY_SCHEMA,
        "graph": graph.to_dict(),
        "arch": arch.to_dict(),
        "level": level.value,
        "use_pipeline": bool(use_pipeline),
        "use_duplication": bool(use_duplication),
        "binding": binding.value,
        "expand": bool(expand),
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def compile_key_for_plan(plan: SchedulePlan) -> str:
    """Content key of the config a ``SchedulePlan`` was built under.

    Reconstructs the knobs from the plan itself (the binding lives on the
    placements' mappings), normalized to ``expand=False`` — program
    expansion changes neither the schedule nor the lowered semantics, so
    executor caches built on this key are shared across expansion modes.
    Plans not produced by ``compile_graph`` (the §4.2 baseline policies
    in ``core.baselines`` tag ``notes["policy"]``) get a distinct suffix:
    their placements differ from the compiler's for the same knobs, and
    under a saturating ADC different tilings compute different values.
    """
    binding = (plan.placements[0].mapping.binding if plan.placements
               else BitBinding.B_TO_XBC)
    key = compile_key(plan.graph, plan.arch,
                      level=plan.notes.get("level"),
                      use_pipeline=plan.use_pipeline,
                      use_duplication=plan.use_duplication,
                      binding=binding, expand=False)
    policy = plan.notes.get("policy")
    return f"{key}:{policy}" if policy else key


def mode_error(arch: CIMArch, level: ComputingMode) -> str:
    """Message for a scheduling level the chip's computing mode does not
    expose.  Single-sourced so the batched proxy's masked-infeasibility
    reasons (dse.proxy_vec) match the scalar raises verbatim."""
    return (f"chip {arch.name} (mode {arch.mode.value}) does not expose "
            f"the {level.value} interface")


def proxy_metrics(
    graph: Graph,
    arch: CIMArch,
    *,
    level: Optional[Union[str, ComputingMode]] = None,
    use_pipeline: bool = True,
    use_duplication: bool = True,
    binding: BitBinding = BitBinding.B_TO_XBC,
) -> dict:
    """Analytic proxy for ``compile_graph(...).metrics()`` — no codegen,
    no segmentation search, no event-driven simulation.

    The cheap rung of the multi-fidelity DSE searcher (dse.search): build
    one placement per CIM node with the real ``CostModel``, run the real
    duplication search over one flat segment, approximate the VVM row
    spread, and read latency off ``estimate_segment_cycles``.  The bundle
    carries the sweep objective keys (``latency_cycles``, ``peak_power``,
    ``crossbars_used``) so a proxy score ranks points the same way a full
    compile would be ranked — absolute values are *not* comparable across
    fidelities, and proxies are never cached on disk.

    Raises like ``compile_graph`` for configurations no compile could
    serve (level above the chip's mode, bit slices that fit no crossbar).

    This scalar path is the *oracle*: ``dse.proxy_vec.proxy_metrics_batch``
    evaluates the same model for an entire array of design points in one
    vectorized pass, bit-exact against this function (infeasible points
    come back masked instead of raising).
    """
    from .cg_opt import (CostModel, balance_duplication,
                         estimate_segment_cycles, greedy_duplication)
    from .mapping import vxb_span_error
    from .mvm_opt import peak_active_xbs

    if isinstance(level, str):
        level = ComputingMode(level)
    level = level or arch.mode
    if not arch.mode.allows(level):
        raise ValueError(mode_error(arch, level))

    cm = CostModel(arch, binding)
    cap_xbs = arch.chip.n_cores * arch.core.n_xbs
    pls = []
    for node in graph.cim_nodes:
        p = cm.placement(node, graph)
        if p.mapping.xbs_per_vxb > cap_xbs:
            raise ValueError(vxb_span_error(node.name, p.mapping.xbs_per_vxb,
                                            cap_xbs))
        pls.append(p)

    budget = arch.chip.n_cores
    multi_segment = sum(p.cores for p in pls) > budget
    if use_duplication and not multi_segment and pls:
        dup = balance_duplication if use_pipeline else greedy_duplication
        if level.allows(ComputingMode.XBM):
            dup(pls, cap_xbs, unit="xbs")
        else:
            dup(pls, budget, unit="cores")

    if level.allows(ComputingMode.WLM):
        # vvm_opt's remap, first-order: spend spare crossbars spreading the
        # worst bottlenecks' row groups
        spare = max(0, cap_xbs - sum(p.dup * p.mapping.n_xbs for p in pls))
        for p in sorted(pls, key=lambda q: -q.stage_cycles):
            if p.row_groups <= 1:
                continue
            per_spread = max(1, p.dup * p.mapping.n_xbs)
            k = min(p.row_groups, 1 + spare // per_spread)
            if k > 1:
                spare -= (k - 1) * per_spread
                p.row_spread = k

    latency = estimate_segment_cycles(pls, use_pipeline)
    rewrite = 0.0
    if multi_segment:
        # every crossbar is reprogrammed per inference; cores write in
        # parallel (cg_opt._rewrite_cycles on the whole placement list)
        n_xbs = sum(p.dup * p.mapping.n_xbs for p in pls)
        rewrite = n_xbs * arch.t_write_xb() / max(arch.chip.n_cores, 1)
        latency += rewrite
    stagger = level.allows(ComputingMode.XBM)
    active = [peak_active_xbs(p, stagger) for p in pls]
    peak = float((sum if use_pipeline else max)(active)) if active else 0.0
    xbs_used = sum(p.dup * p.mapping.n_xbs for p in pls)
    if multi_segment:
        xbs_used = min(xbs_used, cap_xbs)   # segments reuse the pool
    return {
        "latency_cycles": float(max(latency, 1e-9)),
        "compute_cycles": float(sum(p.stage_cycles for p in pls)),
        "rewrite_cycles": float(rewrite),
        "peak_power": peak,
        "crossbars_used": int(xbs_used),
        "fidelity": "proxy",
    }


def compile_graph(
    graph: Graph,
    arch: CIMArch,
    *,
    level: Optional[Union[str, ComputingMode]] = None,
    use_pipeline: bool = True,
    use_duplication: bool = True,
    binding: BitBinding = BitBinding.B_TO_XBC,
    expand: bool = False,
    cache=None,
) -> CompileResult:
    """Compile ``graph`` for ``arch`` and emit the meta-operator flow.

    ``cache`` (or a process-wide default installed via
    ``set_compile_cache``) short-circuits recompiles of identical
    configurations; a hit returns the cached ``CompileResult`` — note its
    ``plan.graph`` is the cache's own copy, not the ``graph`` argument.
    """
    if isinstance(level, str):
        level = ComputingMode(level)
    level = level or arch.mode
    if not arch.mode.allows(level):
        raise ValueError(mode_error(arch, level))

    t0 = time.perf_counter()
    cache = cache if cache is not None else _COMPILE_CACHE
    key = compile_key(graph, arch, level=level, use_pipeline=use_pipeline,
                      use_duplication=use_duplication, binding=binding,
                      expand=expand)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:    # schema-2 entries are stored with key set
            _note_compile(graph, arch, level, key, cached=True,
                          wall_s=time.perf_counter() - t0, plan=hit.plan)
            return hit

    def build(ping_pong: bool) -> SchedulePlan:
        plan = cg_opt.run(graph, arch, use_pipeline=use_pipeline,
                          use_duplication=use_duplication, binding=binding,
                          ping_pong=ping_pong)
        plan.notes["level"] = level
        if level.allows(ComputingMode.XBM):
            mvm_opt.run(plan)
        if level.allows(ComputingMode.WLM):
            vvm_opt.run(plan)
        return plan

    plan = build(ping_pong=False)
    if len(plan.segments) > 1:
        # weight reloads are on the critical path: consider double-buffered
        # (ping-pong) scheduling that hides rewrites behind compute at the
        # price of half the compute pool per segment.
        from ..cimsim import perf
        try:
            alt = build(ping_pong=True)
        except ValueError:
            alt = None   # half the pool cannot hold one placement chunk
        if alt is not None and \
                perf.estimate(alt).latency_cycles < perf.estimate(plan).latency_cycles:
            plan = alt
        else:  # rebuild to restore node.sched annotations of the winner
            plan = build(ping_pong=False)

    program = codegen.emit(plan, expand=expand)
    program.validate()
    result = CompileResult(plan=plan, program=program, key=key)
    if cache is not None:
        cache.put(key, result)
    _note_compile(graph, arch, level, key, cached=False,
                  wall_s=time.perf_counter() - t0, plan=plan)
    return result


def _note_compile(graph, arch, level, key, *, cached, wall_s, plan) -> None:
    """Telemetry for one ``compile_graph`` return (hit or fresh build).

    Disabled telemetry costs two ``is None`` checks and one list
    truthiness test; the span is drawn back from "now" so the compile
    occupies its real wall interval on the compiler track.  The flow
    start seeds the compile→dispatch arrow the executor's first
    dispatch of this artifact closes (ids derive from the compile key
    prefix on both sides — see ``cimsim.executor.lower``).
    """
    reg = obs_metrics.active()
    if reg is not None:
        reg.counter("compiles_total", workload=graph.name,
                    cached=cached).inc()
        reg.histogram("compile_wall_s", cached=cached).observe(wall_s)
    tr = obs_trace.get_trace()
    if tr is not None:
        now = obs_trace.now_s()
        tr.complete(obs_trace.COMPILER_TRACK, graph.name,
                    f"compile:{graph.name}", "compile",
                    now - wall_s, wall_s, level=level.value, cached=cached,
                    segments=len(plan.segments), key=key[:12])
        tr.flow_start(obs_trace.COMPILER_TRACK, graph.name,
                      "artifact", "flow", now - wall_s / 2,
                      flow_id=int(key[:12], 16), key=key[:12])
    obs_hooks.emit("compile.done", graph=graph.name, arch=arch.name,
                   key=key, cached=cached, wall_s=wall_s,
                   level=level.value, segments=len(plan.segments),
                   ping_pong=bool(plan.notes.get("ping_pong", False)))
