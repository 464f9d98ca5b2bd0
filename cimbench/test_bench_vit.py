"""The cell ``vit-jia.b8`` rehearsed on the CPU through the harness: its
configuration and family module (``models/vit.py``) as they stand, at a
small size (32x32 images in 16x16 patches, d = 32 over 4 heads of 8,
d_ff = 512 so that fc2's reads saturate jia's ADC, 2 layers), held
against the reference, with the faults and the control the check has to
catch, and the operations its mfu counts at the published size."""
import time

import numpy as np
import pytest
import torch

from cimbench import control, counts, harness
from cimbench.test_bench_cell import SEED, _broken

NAME = "vit-jia.b8"
SMALL = dict(in_hw=32, patch=16, d=32, n_layers=2, n_heads=4, d_ff=512,
             n_classes=10)


@pytest.fixture
def cell():
    c = harness.load_cell(NAME)
    c.config = dict(c.config, **SMALL)
    c.traffic = dict(c.traffic, batch=2)
    return c


def rehearse(cell):
    return harness.run_cell(cell, SEED, 0.5, False,
                            t_start=time.perf_counter(), device="cpu")


def test_rehearsal_is_correct(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "infer_per_s"}


@pytest.mark.parametrize("fault", ["answer", "half_batch", "permuted"])
def test_broken_timed_path_is_caught(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    res = rehearse(cell)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_control_is_caught(cell):
    checks = control.control(cell, SEED, torch.device("cpu"))
    assert not harness.passed(checks)
    assert checks["wrong_answers"]["value"] > 0


def test_answers_differ_between_images(cell):
    inp = harness.make_inputs(cell, SEED, torch.device("cpu"))
    ref = harness.reference_outputs(cell, inp, torch.device("cpu"))
    rows = ref["head.out"].reshape(len(inp.pool), -1)
    assert len(np.unique(rows, axis=0)) == len(rows)


def test_mvm_operations_at_the_published_size():
    """2 x (12 layers x 7,077,888 weights x 197 rows + 589,824 x 196
    patches + 768,000 x 1) x 64 planes, 9.29x ResNet-18's on jia."""
    full = harness.load_cell(NAME)
    ops = counts.mvm_ops_per_image(full.layers, full.in_shape, full.xb)
    assert ops == 2_156_608_094_208
    resnet = harness.load_cell("resnet18-jia.b16")
    assert counts.mvm_ops_per_image(resnet.layers, resnet.in_shape,
                                    resnet.xb) == 232_201_388_032
