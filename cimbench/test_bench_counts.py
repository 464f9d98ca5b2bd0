"""The yardstick's arithmetic against hand-worked numbers."""
import pytest

from cimbench import counts, reference, trace
from cimbench.models import resnet

JIA = reference.Crossbar(act_bits=8, weight_bits=8, dac_bits=1, cell_bits=1,
                         parallel_row=1152, adc_bits=8)
ISAAC = reference.Crossbar(act_bits=8, weight_bits=8, dac_bits=1,
                           cell_bits=2, parallel_row=8, adc_bits=8)
H100 = counts.peaks("NVIDIA H100 80GB HBM3")
RESNET18 = {"in_channels": 3, "in_hw": 224, "n_classes": 1000,
            "blocks": [2, 2, 2, 2], "widths": [64, 128, 256, 512]}


def test_crossbars():
    assert (JIA.phases, JIA.slices) == (8, 8)
    assert (ISAAC.phases, ISAAC.slices) == (8, 4)
    # jia: 1152 one-bit products can reach 1152 > 255; isaac: 8 * 1 * 3
    assert not JIA.exact() and JIA.exact(255) and not JIA.exact(256)
    assert ISAAC.exact() and ISAAC.exact(4608)
    assert counts.operand_bytes(JIA) == 1


def test_launch_bound():
    # (T, M, R, C) = (1, 200704, 147, 64): ops 2*200704*64*147*64
    # = 241,692,573,696 over 1979e12 = 122.13 us; bytes
    # 200704*147 + 147*64 + 200704*64*4 = 80,892,672 over 3.35e12
    # = 24.15 us: operations bound it
    got = counts.launch_bound_s([(1, 200704, 147, 64)], JIA, H100)
    assert got == pytest.approx(241_692_573_696 / 1979e12)
    # a skinny launch is bound by its bytes: (1, 16, 512, 488):
    # ops 2*16*488*512*64 = 511,705,088 -> 0.2586 us;
    # bytes 16*512 + 512*488 + 16*488*4 = 289,280 -> 0.08635 us
    small = counts.launch_bound_s([(1, 16, 512, 488)], JIA, H100)
    assert small == pytest.approx(511_705_088 / 1979e12)
    bytes_bound = counts.launch_bound_s([(1, 1, 4096, 4096)], JIA, H100)
    assert bytes_bound == pytest.approx(
        (4096 + 4096 * 4096 + 4096 * 4) / 3.35e12)


def test_resnet18_operations():
    layers = resnet.layers(RESNET18)
    wins = counts.windows(layers, resnet.input_shape(RESNET18))
    assert wins["conv1"] == 112 * 112 and wins["fc"] == 1
    assert wins["conv3"] == 56 * 56
    # ResNet-18 at 224: 1,814,073,344 multiply-adds in its 21 crossbar
    # layers (convolutions and the classifier)
    macs = sum(wins[l["name"]] * l["cin"] * l.get("k", 1) ** 2 * l["cout"]
               for l in layers if l["op"] in ("conv", "fc"))
    assert macs == 1_814_073_344
    assert counts.mvm_ops_per_image(layers, (3, 224, 224), ISAAC) \
        == 2 * macs
    assert counts.mvm_ops_per_image(layers, (3, 224, 224), JIA) \
        == 2 * macs * 64
    assert len(reference.weight_shapes(layers)) == 21


def test_token_fc_counts_every_row():
    """A Gemm over 197 tokens (ViT-B/16's 196 patches and its class
    token) states 197 rows an image, and counts 197 single rows' work."""
    one = [dict(op="fc", name="wq", inputs=["input"], output="wq.out",
                cin=768, cout=768)]
    tokens = [dict(one[0], rows=197)]
    assert counts.windows(tokens, (197, 768)) == {"wq": 197}
    assert counts.windows(one, (197, 768)) == {"wq": 1}
    for xb in (JIA, ISAAC):
        assert counts.mvm_ops_per_image(tokens, (197, 768), xb) \
            == 197 * counts.mvm_ops_per_image(one, (197, 768), xb)


def test_percent():
    assert counts.percent(1.0, 4.0) == 25.0
    assert counts.percent(1.0, 0.0) is None
    with pytest.raises(KeyError):
        counts.peaks("Tesla V100")


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def test_trace_reduction():
    ev = [
        _ev("user_annotation", trace.DISPATCH, 100, 100),
        _ev("cpu_op", "aten::copy_", 100, 20),
        _ev("cuda_runtime", "cudaMemcpyAsync", 105, 10, correlation=1),
        _ev("gpu_memcpy", "Memcpy HtoD", 110, 10, correlation=1),
        _ev("user_annotation", trace.CIM_MVM, 130, 10),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 132, 3, correlation=2),
        _ev("kernel", "wgmma", 140, 40, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=3),
        _ev("kernel", "add", 180, 5, correlation=3),
        _ev("kernel", "before", 50, 10, correlation=9),
    ]
    win = trace.window(ev)
    assert win == (100, 200)
    ops = trace.device_ops(ev, win)
    assert [o["name"] for o in ops] == ["Memcpy HtoD", "wgmma", "add"]
    # busy [110,120) + [140,185): 55 of 100 us
    assert trace.busy_us(ops, win) == 55
    assert [o["name"] for o in trace.launched_in(ev, ops, trace.CIM_MVM)] \
        == ["wgmma"]
    assert trace.top_ops(ops) == [["wgmma", 40e-6], ["Memcpy HtoD", 10e-6],
                                  ["add", 5e-6]]
    # gaps by what was open when each began: [100,110) in aten::copy_,
    # [120,140) and [185,200) in the annotation alone
    gaps = dict((k, round(v * 1e6, 6)) for k, v in
                trace.idle_gaps(ev, ops, win))
    assert gaps == {trace.DISPATCH: 35.0, "aten::copy_": 10.0}
    # a device trace has no annotations: its window is its CUDA activity
    dev = [e for e in ev if e["cat"] not in ("user_annotation", "cpu_op")]
    assert trace.window(dev) == (50, 185)
    assert dict(trace.idle_gaps(dev, trace.device_ops(dev, (105, 185)),
                                (105, 185)))["host"] == pytest.approx(
        (5 + 2 + 13) * 1e-6)
