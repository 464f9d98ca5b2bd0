"""The cell ``deepseek-v2-lite-jia.b2`` rehearsed on the CPU through the
harness: its configuration and family module (``models/deepseek_v2.py``)
as they stand, at a small size (24 tokens, d = 64 over 4 heads of 16 + 8
rope / 16 value dims, latent 32, 16 routed experts of which 4 are held,
top-4, a dense layer of 512 so that its down projection's reads saturate
jia's ADC, 2 layers), held against the reference, with the faults and
the control the check has to catch; the layer list against the served
graph; the expert share against the uncut layer; and the operations its
mfu counts at the published size."""
import time

import numpy as np
import pytest
import torch

from cimbench import control, counts, harness, reference
from cimbench.models import deepseek_v2 as plain
from cimbench.test_bench_cell import SEED, _broken

NAME = "deepseek-v2-lite-jia.b2"
SMALL = dict(prompt_tokens=24, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, kv_lora_rank=32, intermediate_size=512,
             moe_intermediate_size=32, num_experts_per_tok=4,
             n_routed_experts=4, experts_held=[0, 1, 2, 3], vocab_size=40,
             published={"n_routed_experts": 16},
             outputs=["lm_head.out", "l1.res2.out"])


@pytest.fixture
def cell():
    c = harness.load_cell(NAME)
    c.config = dict(c.config, **SMALL)
    return c


def rehearse(cell):
    return harness.run_cell(cell, SEED, 0.5, False,
                            t_start=time.perf_counter(), device="cpu")


def test_layer_list_is_the_served_graph(cell):
    """``program_graph`` holds the served graph's crossbar layers (names
    and weight shapes, in order) to the family's; at the published size
    too, where they are 508.8 M weights."""
    graph, _, _ = harness.program_graph(cell)
    assert [n.name for n in graph.cim_nodes][:4] == \
        ["l0.wq", "l0.wkva", "l0.wkvb", "l0.wo"]
    full = harness.load_cell(NAME)
    from repro_torch.core.graph import weight_matrix_shape
    from repro_torch.workloads import get_workload
    g = get_workload(full.config["workload"],
                     **full.model.build_kwargs(full.config))
    got = [(n.name, tuple(weight_matrix_shape(n))) for n in g.cim_nodes]
    assert got == reference.weight_shapes(full.layers)
    assert sum(r * c for _, (r, c) in got) == 508_821_504
    assert g.outputs == ["lm_head.out"]
    assert full.outputs == ["lm_head.out", "l4.res2.out"]


def test_rehearsal_is_correct(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "infer_per_s"}


@pytest.mark.parametrize("fault", ["answer", "permuted"])
def test_broken_timed_path_is_caught(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    res = rehearse(cell)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_control_is_caught(cell):
    checks = control.control(cell, SEED, torch.device("cpu"))
    assert not harness.passed(checks)
    assert checks["wrong_answers"]["value"] > 0


def test_answers_differ_between_prompts(cell):
    inp = harness.make_inputs(cell, SEED, torch.device("cpu"))
    ref = harness.reference_outputs(cell, inp, torch.device("cpu"))
    rows = ref["lm_head.out"].reshape(len(inp.pool), -1)
    assert len(np.unique(rows, axis=0)) == len(rows)


def _moe_sums(cfg, held, h, weights):
    """The combine's int64 accumulator of one MoE layer whose chip holds
    ``held``, on the rows ``h``: the plain operators on the plain Mvm."""
    xb = reference.Crossbar.from_config(cfg)
    mvm = {name: reference.Mvm(w, xb, xb.act_bits)
           for name, w in weights.items()}
    shifts = {}

    def fc(name, x):
        y = mvm[name](x)
        shifts.setdefault(name, reference.pick_shift(y))
        return reference.requant(y, shifts[name])

    logits = fc("router", h)
    gates = plain.OPS["router"]([logits], dict(top_k=4, scaling=1.0))
    outs = []
    for e in held:
        g = plain.OPS["silu"]([fc(f"e{e}.w_gate", h)], {})
        u = fc(f"e{e}.w_up", h)
        m = plain.OPS["mul"]([g, u], {})
        m = reference.requant(m, reference.pick_shift(m))
        outs.append(fc(f"e{e}.w_down", m))
    return plain.OPS["moe"]([gates] + outs, dict(experts=list(held)))


def test_expert_shares_add_up_to_the_uncut_layer():
    """16 experts shared by 4 chips of 4: the combine's int64
    accumulators the 4 shares give add up to the uncut layer's (the
    shared experts, which every chip computes alike, counted once, so
    left out of all five here)."""
    cfg = harness.load_cell(NAME).config
    gen = torch.Generator().manual_seed(11)
    d, ff, n = 64, 32, 16
    h = torch.randint(-128, 128, (1, 24, d), generator=gen)
    w = {"router": torch.randint(-128, 128, (d, n), generator=gen)}
    for e in range(n):
        for name, rc in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                         ("w_down", (ff, d))):
            w[f"e{e}.{name}"] = torch.randint(-128, 128, rc, generator=gen)
    whole = _moe_sums(cfg, range(n), h, w)
    parts = [_moe_sums(cfg, range(4 * c, 4 * c + 4), h, w)
             for c in range(4)]
    assert torch.equal(sum(parts), whole)
    assert all(p.abs().sum() > 0 for p in parts)


def test_mvm_operations_at_the_published_size():
    """2 x 2048 rows x (5 layers of MLA, 13.8 M weights; the dense SwiGLU,
    67.2 M; 4 routers and shared SwiGLUs, 17.4 M) + 192 rows x 4 x 8
    experts of 8.65 M + 1 row x 26.2 M, x 64 planes."""
    full = harness.load_cell(NAME)
    assert plain.rows_per_expert(full.config) == 192
    ops = counts.mvm_ops_per_image(full.layers, full.in_shape, full.xb)
    attn = 5 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    dense = 3 * 2048 * 10944
    shared = 4 * (2048 * 64 + 3 * 2048 * 2816)
    experts = 4 * 8 * 3 * 2048 * 1408
    want = 2 * 64 * (2048 * (attn + dense + shared) + 192 * experts
                     + 2048 * 12800)
    assert ops == want
