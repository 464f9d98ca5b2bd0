"""Cells as DTensor programs across 4 gloo ranks, against the plain cells.

The reduced qwen1.5-4b and mixtral-8x7b prefill, decode and train cells
(float32), default and ``OPTIMIZED``, run on a ("data", "model") = 2x2
host mesh of 4 ranks under ``python -m torch.distributed.run`` (one
process per device; ``mesh_ranks.py cells``), each beside the plain
cell on the same draw: every floating result, and the train step's
updated params and moments, within 1e-6 of its largest value (2.2e-7 at
most, measured on this CPU); integer leaves equal; no op replicated
(``bmm`` least of all), but for the train step's ``index_put`` under a
torch older than 2.13 (``mesh_ranks.replicated_allowed``).
Unlike a 1x1 mesh, here every sharding constraint and every partial sum
is a real collective.
"""
import json

import pytest

from mesh_ranks import CELL_ARCHS, CELL_SHAPES, PERFS, replicated_allowed
from test_torch_mesh_train import DRIVER, run_ranks

REL = 1e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_cells") / "cells.json"
    run_ranks(4, [DRIVER, "cells", out], timeout=300)
    return json.loads(out.read_text())


@pytest.mark.parametrize("kind", [s.kind for s in CELL_SHAPES])
@pytest.mark.parametrize("perf", sorted(PERFS))
@pytest.mark.parametrize("name", CELL_ARCHS)
def test_2x2_cells_equal_plain_cells(results, name, perf, kind):
    rec = results[f"{name}:{perf}:{kind}"]
    assert rec["finite"] and rec["ints_equal"], rec
    assert rec["err"] <= REL, rec
    assert "bmm" not in rec["replicated_ops"], rec
    assert set(rec["replicated_ops"]) <= replicated_allowed(kind), rec
