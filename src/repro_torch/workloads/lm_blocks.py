"""Assigned-LM-architecture blocks as CIM workloads (DESIGN.md §4).

Builds the computation graph of one decoder block of any assigned
architecture so the CIM-MLC compiler can schedule it: weight-stationary
projections (Q/K/V/O, MLP, expert FFNs, SSM in/out projections) map to
crossbars; attention QK^T/AV MatMuls, softmax, routing and the SSD scan
are ALU (DCOM) operators — the weight-stationary applicability split.
"""
from __future__ import annotations

from typing import List

from ..configs import get_config
from ..core.graph import Graph, Node


def lm_block(arch: str, seq: int = 512) -> Graph:
    cfg = get_config(arch)
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nodes: List[Node] = []
    t = "x"

    def gemm(name, tin, cin, cout):
        nodes.append(Node(name, "Gemm", [tin], [f"{name}.out"],
                          {"weight_shape": (cin, cout)}))
        return f"{name}.out"

    spec = cfg.unit[0]
    nodes.append(Node("ln1", "RMSNorm", [t], ["ln1.out"]))
    t_in = "ln1.out"

    if spec.mixer in ("attn", "hybrid", "mla"):
        if spec.mixer == "mla":
            q = gemm("wq", t_in, d, h * (cfg.qk_nope_dim + cfg.qk_rope_dim))
            ckv = gemm("w_dkv", t_in, d, cfg.kv_lora + cfg.qk_rope_dim)
            kk = gemm("w_uk", ckv, cfg.kv_lora + cfg.qk_rope_dim,
                      h * cfg.qk_nope_dim)
            v = gemm("w_uv", ckv, cfg.kv_lora + cfg.qk_rope_dim,
                     h * cfg.v_head_dim)
            att_dim = h * cfg.v_head_dim
        else:
            q = gemm("wq", t_in, d, h * hd)
            kk = gemm("wk", t_in, d, k * hd)
            v = gemm("wv", t_in, d, k * hd)
            att_dim = h * hd
        nodes.append(Node("qkt", "MatMul", [q, kk], ["qkt.out"],
                          {"transpose_b": True}))
        nodes.append(Node("smax", "Softmax", ["qkt.out"], ["smax.out"]))
        nodes.append(Node("av", "MatMul", ["smax.out", v], ["av.out"]))
        o = gemm("wo", "av.out", att_dim, d)
        nodes.append(Node("res1", "Add", [t, o], ["res1.out"]))
        t = "res1.out"

    if spec.mixer in ("ssm", "hybrid"):
        di = cfg.d_inner
        xs = gemm("w_x", t_in, d, di)
        nodes.append(Node("ssd", "SSMScan", [xs], ["ssd.out"]))
        op = gemm("out_proj", "ssd.out", di, d)
        nodes.append(Node("res_s", "Add", [t, op], ["res_s.out"]))
        t = "res_s.out"

    if spec.mlp != "none":
        nodes.append(Node("ln2", "RMSNorm", [t], ["ln2.out"]))
        if spec.mlp == "moe":
            nodes.append(Node("router", "TopKRouter", ["ln2.out"],
                              ["router.out"],
                              {"n_experts": cfg.n_experts}))
            outs = []
            for e in range(cfg.n_experts):
                hh = gemm(f"e{e}_wi", "ln2.out", d, cfg.moe_d_ff)
                nodes.append(Node(f"e{e}_act", "Silu", [hh],
                                  [f"e{e}_act.out"]))
                outs.append(gemm(f"e{e}_wo", f"e{e}_act.out",
                                 cfg.moe_d_ff, d))
            acc = outs[0]
            for e, o in enumerate(outs[1:], 1):
                nodes.append(Node(f"moe_add{e}", "Add", [acc, o],
                                  [f"moe_add{e}.out"]))
                acc = f"moe_add{e}.out"
            y = acc
        else:
            hh = gemm("wi", "ln2.out", d, cfg.d_ff)
            nodes.append(Node("act", "Gelu" if cfg.act == "gelu" else "Silu",
                              [hh], ["act.out"]))
            y = gemm("wo_mlp", "act.out", cfg.d_ff, d)
        nodes.append(Node("res2", "Add", [t, y], ["res2.out"]))
        t = "res2.out"

    return Graph(f"lmblock-{arch}", nodes, {"x": (seq, d)}, [t])
