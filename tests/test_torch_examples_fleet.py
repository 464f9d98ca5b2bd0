"""The port's fleet example against its JAX original, on the CPU, whole:
ResNet-18@16 and a 2-layer ViT co-resident on ``isaac-baseline`` serve
the same 12-request trace, each example asserting inside that every
fleet output is bit-exact against a standalone ``CimBatchService``.
Both stdouts must be equal once the wall-clock fields are masked (the
warm-up and serving seconds and the p50/p95 latencies, which come from
the wall clock); plan, batch counts and deadline misses included.
"""
from test_torch_examples import assert_same_stdout, load, run_main


def test_serve_cim_fleet_matches_reference():
    _, want = run_main(load("examples/serve_cim_fleet.py"))
    done, got = run_main(load("examples/serve_cim_fleet_torch.py"),
                         ["--device", "cpu"])
    assert len(done) == 12 and all(r.outputs for r in done)
    assert got.count("fleet outputs bit-exact") == 2
    assert_same_stdout(want, got)
