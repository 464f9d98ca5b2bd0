"""Plain PyTorch version of the bit-sliced CIM crossbar MVM.

Models the analog compute semantics of a CIM crossbar array exactly
(§3.2.3): the input vector is presented bit-serially (``dac_bits`` per
phase), weights are stored as ``cell_bits`` slices in adjacent columns,
at most ``parallel_row`` wordlines are activated per analog read, the
column current is digitized by an ``adc_bits`` ADC (saturating), and the
digital shift-accumulate combines phases / slices / row groups:

    y[m,c] = sum_g sum_p sum_s 2^(p*db + s*cb) *
             ADC( sum_{r in group g} x_p[m,r] * w_s[r,c] )

This is the route CPU tensors take, and what the CUDA kernel is held
against bit for bit on the card.  PyTorch has no int32 matrix product on
CUDA, so each group's dot runs in float64: a group sum is below 2^24
wherever these parameters are used (see ``exact_adc_bits``), far inside
float64's exact-integer range, and the result is cast back to int32.
The same code therefore runs on the CPU and on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def bit_planes(x: torch.Tensor, total_bits: int,
               plane_bits: int) -> torch.Tensor:
    """Decompose unsigned ints into ceil(total/plane) planes (LSB first).

    Returns (n_planes, *x.shape) int32 with each plane < 2**plane_bits.
    """
    n = math.ceil(total_bits / plane_bits)
    x = x.to(torch.int32)
    mask = (1 << plane_bits) - 1
    return torch.stack([(x >> (i * plane_bits)) & mask for i in range(n)])


def adc_saturate(v: torch.Tensor, adc_bits: int) -> torch.Tensor:
    return torch.clamp(v, max=(1 << adc_bits) - 1)


def cim_mvm_ref(x_u: torch.Tensor, w_u: torch.Tensor, *, act_bits: int,
                weight_bits: int, dac_bits: int, cell_bits: int,
                parallel_row: int, adc_bits: int) -> torch.Tensor:
    """(M,R) uint x  @  (R,C) uint w  ->  (M,C) int32: the tile-batched
    version at T = 1."""
    assert x_u.shape[1] == w_u.shape[0], (x_u.shape, w_u.shape)
    return cim_mvm_ref_tiles(
        x_u[None], w_u[None], act_bits=act_bits, weight_bits=weight_bits,
        dac_bits=dac_bits, cell_bits=cell_bits, parallel_row=parallel_row,
        adc_bits=adc_bits)[0]


def cim_mvm_ref_tiles(x_u: torch.Tensor, w_u: torch.Tensor, *,
                      act_bits: int, weight_bits: int, dac_bits: int,
                      cell_bits: int, parallel_row: int,
                      adc_bits: int) -> torch.Tensor:
    """Tile-batched: (T,M,R) uint x  @  (T,R,C) uint w -> (T,M,C) int32.

    One batched float64 product per (phase, slice) pair, with tiles and
    parallel-row groups on the batch axes.  Rows are zero-padded to a
    whole number of groups in the *unsigned* domain: padded rows add 0
    to every group's analog sum, so the ADC sees identical values.
    """
    t, m, r = x_u.shape
    t2, r2, c = w_u.shape
    assert (t, r) == (t2, r2), (x_u.shape, w_u.shape)
    pr = min(parallel_row, r)
    n_groups = math.ceil(r / pr)
    pad_r = n_groups * pr - r
    if pad_r:
        x_u = F.pad(x_u, (0, pad_r))
        w_u = F.pad(w_u, (0, 0, 0, pad_r))

    xp = bit_planes(x_u, act_bits, dac_bits)          # (P, T, M, R')
    ws = bit_planes(w_u, weight_bits, cell_bits)      # (S, T, R', C)
    n_p, n_s = xp.shape[0], ws.shape[0]

    out = torch.zeros((t, m, c), dtype=torch.int32, device=x_u.device)
    for p in range(n_p):
        # (T, G, M, pr): groups join the tile batch axis
        xg = xp[p].reshape(t, m, n_groups, pr).transpose(1, 2) \
            .to(torch.float64)
        for s in range(n_s):
            wg = ws[s].reshape(t, n_groups, pr, c).to(torch.float64)
            part = torch.matmul(xg, wg).to(torch.int32)   # (T, G, M, C)
            part = adc_saturate(part, adc_bits)
            out += part.sum(dim=1, dtype=torch.int32) \
                << (p * dac_bits + s * cell_bits)
    return out


def exact_adc_bits(act_bits: int, weight_bits: int, dac_bits: int,
                   cell_bits: int, parallel_row: int) -> int:
    """Smallest ADC width that never saturates (exact integer matmul)."""
    vmax = parallel_row * ((1 << dac_bits) - 1) * ((1 << cell_bits) - 1)
    return max(1, math.ceil(math.log2(vmax + 1)))
