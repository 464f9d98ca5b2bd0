"""Run-level performance options (§Perf hillclimbing levers).

These are *scheduling* choices, not architecture hyperparameters, so
they live outside ModelConfig; the defaults reproduce the paper-faithful
baseline, and the dry-run's ``--opt`` mode enables the optimized set.
Threaded via a context manager so the model code stays signature-stable.

Levers (each a recorded hypothesis->measure iteration in EXPERIMENTS.md):
  * ``triangular_attention`` — blockwise attention iterates only visible
    (q-block, kv-block) pairs (causal lower-triangle / sliding-window
    band) instead of the full nq x nk grid: ~2x less attention compute
    and HBM traffic for causal, ~S/window for banded prefill.
  * ``attn_reshard`` — explicit sharding constraints around attention:
    "head" shards heads on "model" when they divide evenly, otherwise
    replicates attention over "model" (trading a little redundant
    compute for eliminating the per-score-block all-reduces that the
    baseline's head_dim-sharded activations induce).
  * ``kv_quant_int8`` — int8 KV cache with per-(position, head) scales:
    halves the decode-attention cache traffic (memory-bound cells).

Every lever does here what it does in the reference.  Two are inert
on one device: the sharding constraints of ``attn_reshard`` and
``moe_capacity_shard`` are the identity where one device holds every
shard, and ``kv_quant_int8`` is read by no code in either package.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PerfOpts:
    triangular_attention: bool = False
    attn_reshard: str = "none"          # none | auto
    kv_quant_int8: bool = False
    remat_policy: str = "full"          # full | dots (save matmul outputs)
    decode_opt: bool = False            # append-style decode, no-cast scores
    moe_capacity_shard: bool = False    # shard expert token buffers on data
    mesh: Optional[object] = None       # concrete mesh for constraints
    batch_axes: Tuple[str, ...] = ("data",)


_CURRENT = PerfOpts()


def current() -> PerfOpts:
    return _CURRENT


@contextlib.contextmanager
def use_perf_opts(opts: PerfOpts):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = opts
    try:
        yield
    finally:
        _CURRENT = prev


# moe_capacity_shard stays OFF: measured a 2.7x collective REGRESSION on
# mixtral train (the xe resharding all-to-alls outweigh the saved
# all-reduces) — kept as a lever, documented as refuted in EXPERIMENTS.md
OPTIMIZED = PerfOpts(triangular_attention=True, attn_reshard="auto",
                     remat_policy="dots", decode_opt=True)
