"""The port's copy of the compiler emits what the JAX package's emits.

Compile keys (content hashes of graph, arch and knobs) and the emitted
meta-operator text must be equal string for string, and the seeded
weights and inputs byte for byte, so the executors of both packages
start from the same program and the same numbers.
"""
import numpy as np
import pytest

from repro.cimsim import functional as jfn
from repro.core import compiler as jcompiler
from repro.core.abstraction import get_arch as jarch
from repro.workloads import get_workload as jwl
from repro_torch.cimsim import functional as tfn
from repro_torch.core import compiler as tcompiler
from repro_torch.core.abstraction import PRESETS, get_arch as tarch
from repro_torch.workloads import get_workload as twl

#: jain-jssc21 is left out for resnet18: its compile alone takes seconds
CASES = ([(wl, arch) for wl in ("tiny_cnn", "tiny_mlp")
          for arch in sorted(PRESETS)]
         + [("resnet18", arch)
            for arch in ("isaac-baseline", "puma", "jia-issc21")])


@pytest.mark.parametrize("wl,arch", CASES)
def test_compile_key_and_program_text_match(wl, arch):
    jg, tg = jwl(wl), twl(wl)
    ja, ta = jarch(arch), tarch(arch)
    assert tcompiler.compile_key(tg, ta) == jcompiler.compile_key(jg, ja)
    jr = jcompiler.compile_graph(jg, ja)
    tr = tcompiler.compile_graph(tg, ta)
    assert tr.key == jr.key
    assert len(tr.plan.segments) == len(jr.plan.segments)
    assert tr.program.to_text() == jr.program.to_text()
    assert tcompiler.compile_key_for_plan(tr.plan) == \
        jcompiler.compile_key_for_plan(jr.plan)


@pytest.mark.parametrize("wl", ["tiny_cnn", "tiny_mlp", "resnet18"])
@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_weights_and_inputs_byte_equal(wl, seed):
    jw, tw = jfn.make_weights(jwl(wl), seed), tfn.make_weights(twl(wl), seed)
    assert list(jw) == list(tw)
    for name in jw:
        assert jw[name].dtype == tw[name].dtype
        assert jw[name].tobytes() == tw[name].tobytes()
    jx, tx = jfn.make_input(jwl(wl), seed), tfn.make_input(twl(wl), seed)
    assert list(jx) == list(tx)
    for name in jx:
        assert jx[name].tobytes() == tx[name].tobytes()
        assert np.asarray(tx[name]).dtype == np.int32
