"""Design-space exploration over the cross-tier scheduling knob space.

CIM-MLC exposes a "tractable yet effective design space" (§4.3-§4.4): the
scheduling level (CM/XBM/WLM, clamped to what the chip's computing mode
allows), the bit-dimension binding (B->XBC vs B->XB), the CG pipeline and
duplication switches, and the Abs-arch parameters themselves (crossbar
geometry, cell precision, parallel rows, core counts).  This package
turns the one-shot compiler into a search service:

  * ``space``    — enumerate valid ``DesignPoint``s of a ``DesignSpace``;
  * ``cache``    — content-addressed, disk-persisted compile cache;
  * ``runner``   — the shared job-queue evaluation primitive
                   (``EvalJob``/``run_jobs``) plus the exhaustive
                   ``sweep`` built on it;
  * ``proxy_vec``— batched structure-of-arrays proxy cost model: the
                   analytic rung for an entire array of design points in
                   one vectorized pass, bit-exact vs the scalar oracle;
  * ``search``   — multi-fidelity successive halving (batched proxy
                   metrics → graph-prefix compiles → full compiles);
  * ``adaptive`` — budgeted ask/tell searcher (TPE-style density model
                   over the categorical + arch axes) batched for the
                   vectorized proxy, promoting a model-chosen shortlist
                   up the same fidelity ladder;
  * ``campaign`` — multi-workload campaigns over one queue + cache,
                   with per-workload frontiers and robust-point summary;
  * ``pareto``   — Pareto frontier over (latency, peak power, crossbars);
  * ``report``   — lm-eval-harness-style scorecards for campaigns and
                   searches (markdown / JSON).

docs/DSE.md is the guide; this package keeps the JAX package's API.
"""
from .adaptive import AdaptiveResult, AdaptiveSearch, adaptive_search
from .cache import (CacheLockTimeout, CompileCache, ForeignEntryError,
                    default_cache_dir, shared_stats)
from .campaign import (CampaignResult, RobustPoint, WorkloadOutcome,
                       robust_points, run_campaign)
from .pareto import DEFAULT_OBJECTIVES, dominates, pareto_frontier
from .proxy_vec import (BatchedProxyMetrics, NodeTensor,
                        proxy_metrics_batch)
from .report import Scorecard, campaign_scorecard, search_scorecard
from .runner import (EvalJob, SweepResult, evaluate_point, run_jobs,
                     sweep)
from .search import (DEFAULT_LADDER, HalvingSearch, Rung, RungLog,
                     SearchResult, successive_halving)
from .space import DesignPoint, DesignSpace, apply_arch_overrides

__all__ = [
    "AdaptiveResult", "AdaptiveSearch", "adaptive_search",
    "CacheLockTimeout", "CompileCache", "ForeignEntryError",
    "default_cache_dir",
    "shared_stats",
    "CampaignResult", "RobustPoint", "WorkloadOutcome",
    "robust_points", "run_campaign",
    "DEFAULT_OBJECTIVES", "dominates", "pareto_frontier",
    "BatchedProxyMetrics", "NodeTensor", "proxy_metrics_batch",
    "Scorecard", "campaign_scorecard", "search_scorecard",
    "EvalJob", "SweepResult", "evaluate_point", "run_jobs", "sweep",
    "DEFAULT_LADDER", "HalvingSearch", "Rung", "RungLog",
    "SearchResult", "successive_halving",
    "DesignPoint", "DesignSpace", "apply_arch_overrides",
]
