"""The executor's row-reducing float ops on an int8-range operand
(``executor._row_dcom``): Softmax, LayerNorm and RMSNorm on the device,
bit-equal to the NumPy float64 path (``functional._float_dcom``, and
``executor._float_host`` after requantization), and the NumPy summation
order they rest on (``executor._pairwise_sum``).

The file imports no JAX, so its card cases run on a card host with
``python -m pytest -q --noconftest -m cuda tests/test_torch_row_dcom.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.cimsim import executor as tex
from repro_torch.cimsim import functional as tfn
from repro_torch.core.graph import Node

SEED = 2_148_031_007

#: (op, Softmax scale, operand shape): ViT's scale 64^-0.5, an unscaled
#: one, and 32^-0.5, whose products are not exact
ROW_CASES = [
    ("Softmax", 0.125, (2, 3, 197, 197)),
    ("Softmax", 1.0, (2, 3, 197, 197)),
    ("Softmax", 32 ** -0.5, (2, 3, 197, 197)),
    ("LayerNorm", None, (2, 197, 768)),
    ("RMSNorm", None, (2, 197, 768)),
]


def _operand(shape, seed: int) -> np.ndarray:
    """Seeded int8 rows, the first four of them edge rows: all equal,
    all -128, one 127 among -128, and -128 alternating with 127."""
    x = np.random.default_rng(seed).integers(-128, 128, shape,
                                              dtype=np.int32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 5
    rows[1] = -128
    rows[2] = -128
    rows[2, shape[-1] // 3] = 127
    rows[3] = np.where(np.arange(shape[-1]) % 2 == 0, -128, 127)
    return x


def _check_row_op(op, scale, shape, device) -> None:
    node = Node("f", op, ["x"], ["f.out"],
                {} if scale is None else {"scale": scale})
    x = _operand(shape, SEED)
    exp = None if scale is None else torch.as_tensor(
        tex._softmax_exp_table(scale), device=device)
    n = torch.tensor(float(shape[-1]), dtype=torch.float64, device=device)
    xd = torch.as_tensor(x, device=device)
    # the float64 answers themselves, before requantization hides most
    # last-bit differences
    np.testing.assert_array_equal(
        tex._row_float(op, xd, exp, n).cpu().numpy(),
        tfn._float_dcom(op, [x], node))
    got = tex._row_dcom(op, xd, exp, n)
    assert got.dtype == torch.int32 and got.device.type == device.type
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tex._float_host(node, x))


def _check_pairwise(n, device) -> None:
    rng = np.random.default_rng(SEED + n)
    v = rng.choice([-1.0, 1.0], (64, n)) * 10.0 ** rng.uniform(-12, 12,
                                                                (64, n))
    got = tex._pairwise_sum(torch.as_tensor(v, device=device))
    assert got.shape == (64, 1)
    np.testing.assert_array_equal(got.cpu().numpy()[:, 0],
                                  np.add.reduce(v, axis=-1))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 128, 129, 197, 768, 3072])
def test_pairwise_sum_is_numpys_order(n):
    """Rows whose magnitudes spread over 24 orders: any other order
    rounds differently on most of them (plain ``torch.sum`` differs on
    a third or more of the rows of 197)."""
    _check_pairwise(n, torch.device("cpu"))


@pytest.mark.parametrize("op, scale, shape", ROW_CASES)
def test_row_op_equals_the_host_path(op, scale, shape):
    _check_row_op(op, scale, shape, torch.device("cpu"))


def test_softmax_exp_table_is_the_references_exponentials():
    """Entry (x, m) is what ``_float_dcom`` computes for x in a row whose
    max is m, at a scale whose products round."""
    s = 32 ** -0.5
    table = tex._softmax_exp_table(s)
    x = np.arange(-128, 128, dtype=np.float64)
    for m in (-128, -1, 0, 127):
        xs = x[x <= m]
        want = np.exp(xs * s - m * s)
        np.testing.assert_array_equal(
            table[(xs.astype(np.int64) + 128) * 256 + m + 128], want)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the checks hold the card's "
                    "float64 kernels to the host's NumPy")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op, scale, shape", ROW_CASES)
def test_row_op_on_the_card_equals_the_host_path(card, op, scale, shape):
    """The card's division and square root round as NumPy's do; a
    division by a host scalar would not (CUDA multiplies by its
    reciprocal), which is why the row length is a device tensor."""
    _check_row_op(op, scale, shape, card)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 197, 768, 3072])
def test_pairwise_sum_on_the_card_is_numpys_order(card, n):
    _check_pairwise(n, card)
