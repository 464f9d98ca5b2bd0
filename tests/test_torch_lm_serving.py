"""The port's LM ``BatchServer`` against the JAX package's, on the CPU.

Both servers get the same ``reduced()`` float32 parameters (drawn by
numpy from a seed, carried over by ``params_from_reference``), 4 slots
and the same 6 requests: prompt lengths 5-12, so every batch is
left-padded, different ``max_new_tokens`` and one ``eos`` that stops
its request early.  The served token lists must be equal, request for
request.
"""
import numpy as np
import pytest
import torch

from repro.serving import BatchServer as JServer
from repro.serving import Request as JRequest
from repro_torch.serving import BatchServer, Request
from test_torch_lm import both_params

PROMPT_LENS = (5, 12, 7, 9, 6, 11)
MAX_NEW = (6, 4, 8, 5, 7, 3)


def _requests(cls, vocab: int, eos=None):
    rng = np.random.default_rng(11)
    out = []
    for i, (n, new) in enumerate(zip(PROMPT_LENS, MAX_NEW)):
        prompt = rng.integers(1, vocab, n).astype(np.int32)
        out.append(cls(i, prompt=prompt, max_new_tokens=new,
                       eos=eos if i == 2 else None))
    return out


@pytest.mark.parametrize("name", ["qwen1.5-4b", "gemma2-2b"])
def test_batch_server_matches_reference(name):
    jcfg, tcfg, jp, tp = both_params(name, seed=5)
    jserver = JServer(jcfg, jp, batch_slots=4, max_len=32)
    first = jserver.serve(_requests(JRequest, jcfg.vocab))
    # request 2 stops at the token it first emits at step 3
    eos = first[2].output[2]
    want = jserver.serve(_requests(JRequest, jcfg.vocab, eos))
    assert len(want[2].output) < MAX_NEW[2]

    server = BatchServer(tcfg, tp, batch_slots=4, max_len=32, device="cpu")
    got = server.serve(_requests(Request, tcfg.vocab, eos))
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.output == w.output, g.rid
        assert len(g.output) <= g.max_new_tokens
        assert g.latency_s > 0


def test_batch_server_stops_at_max_len():
    """A batch whose prompt fills ``max_len`` decodes no further: one
    token from the prefill, as in the reference."""
    jcfg, tcfg, jp, tp = both_params("qwen1.5-4b", seed=6)
    reqs = {}
    for cls, server in ((JRequest, JServer(jcfg, jp, batch_slots=2,
                                           max_len=12)),
                        (Request, BatchServer(tcfg, tp, batch_slots=2,
                                              max_len=12, device="cpu"))):
        r = [cls(0, prompt=np.arange(1, 13, dtype=np.int32),
                 max_new_tokens=5)]
        reqs[cls] = server.serve(r)[0].output
    assert len(reqs[Request]) == 1 and reqs[Request] == reqs[JRequest]


def test_batch_server_rejects_params_on_another_device(monkeypatch):
    _, tcfg, _, tp = both_params("qwen1.5-4b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="params live on cpu"):
        BatchServer(tcfg, tp, device="cuda")
