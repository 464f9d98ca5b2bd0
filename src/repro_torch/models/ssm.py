"""Mamba2 SSD (state-space duality) blocks — chunked scan and O(1)-state
decode step, in float32.  A port of ``repro.models.ssm``: the scan over
chunks is a Python loop.

Recurrence (per head h, head dim P, state N, shared B/C of one group):

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D * x_t

The chunked SSD form: an intra-chunk quadratic attention-like term plus
an inter-chunk state recurrence, which keeps temp memory O(chunk^2).

Simplifications vs the reference implementation (recorded in DESIGN.md
§3/§4): the short causal conv1d on x/B/C is omitted, and n_groups = 1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .layers import pad_seq


def segsum(dtA: torch.Tensor) -> torch.Tensor:
    """dtA: (..., Q) -> (..., Q, Q) lower-triangular pairwise decay sums:
    out[t, s] = sum_{s < u <= t} dtA[u]  (for s <= t)."""
    q = dtA.shape[-1]
    cs = torch.cumsum(dtA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]           # (..., t, s)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=dtA.device))
    return torch.where(mask, diff, -torch.inf)


def _chunk_states(xc, dtc, Bc, dtA):
    """Per-chunk end states and decays of the chunked form.

    xc: (bt,nc,q,h,p); dtc, dtA: (bt,nc,q,h); Bc: (bt,nc,q,n).  Returns
    (cum (bt,nc,q,h), states (bt,nc,h,p,n), chunk_decay (bt,nc,h))."""
    cum = torch.cumsum(dtA, dim=2)                       # (bt,nc,q,h)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (bt,nc,q,h)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn",
                          Bc, dtc * decay_to_end, xc)    # (bt,nc,h,p,n)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (bt,nc,h)
    return cum, states, chunk_decay


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             chunk: int = 256) -> torch.Tensor:
    """Chunked SSD forward.

    x:  (Bt, S, H, P)    inputs per head
    dt: (Bt, S, H)       positive step sizes (post-softplus)
    A:  (H,)             negative decay rates
    B:  (Bt, S, N)       input projection to state (n_groups=1)
    C:  (Bt, S, N)       state readout
    D:  (H,)             skip
    returns (Bt, S, H, P)
    """
    bt, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        # dt=0 on padding -> decay 1, zero state contribution
        out = ssd_scan(pad_seq(x, pad), pad_seq(dt, pad), A,
                       pad_seq(B, pad), pad_seq(C, pad), D, chunk)
        return out[:, :s]
    nc = s // q

    xf = x.float()
    xc = xf.reshape(bt, nc, q, h, p)
    dtc = dt.float().reshape(bt, nc, q, h)
    Bc = B.float().reshape(bt, nc, q, n)
    Cc = C.float().reshape(bt, nc, q, n)
    dtA = dtc * A.float()                                # (bt,nc,q,h)

    # ---- intra-chunk (quadratic within the chunk) ----
    Lmat = torch.exp(segsum(torch.movedim(dtA, -1, -2)))  # (bt,nc,h,q,q)
    CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)         # (bt,nc,q,q)
    W = CB[:, :, None] * Lmat                            # (bt,nc,h,q,q)
    xdt = xc * dtc[..., None]                            # (bt,nc,q,h,p)
    y_intra = torch.einsum("bchts,bcshp->bcthp", W, xdt)

    # ---- chunk states, then the recurrence over chunks ----
    cum, states, chunk_decay = _chunk_states(xc, dtc, Bc, dtA)
    hstate = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # (bt,nc,h,p,n)

    # ---- inter-chunk contribution ----
    in_decay = torch.exp(cum)                            # (bt,nc,q,h)
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp", Cc, in_decay, h_prevs)

    y = y_intra + y_inter + xc * D.float()[:, None]
    return y.reshape(bt, s, h, p).to(x.dtype)


def ssd_final_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, chunk: int) -> torch.Tensor:
    """Final SSM state after a prompt (for the prefill -> decode handoff),
    by the same chunked recurrence as ``ssd_scan``."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x, dt, B = pad_seq(x, pad), pad_seq(dt, pad), pad_seq(B, pad)
        s += pad
    nc = s // q
    xc = x.float().reshape(bt, nc, q, h, p)
    dtc = dt.float().reshape(bt, nc, q, h)
    Bc = B.float().reshape(bt, nc, q, n)
    _, states, chunk_decay = _chunk_states(xc, dtc, Bc, dtc * A.float())
    hstate = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
    for c in range(nc):
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    return hstate


def ssd_decode_step(hstate: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.

    hstate: (Bt, H, P, N); x: (Bt, H, P); dt: (Bt, H); B,C: (Bt, N).
    Returns (new_state, y (Bt, H, P))."""
    dtf = dt.float()
    dec = torch.exp(dtf * A.float())                     # (Bt,H)
    upd = torch.einsum("bn,bh,bhp->bhpn", B.float(), dtf, x.float())
    hnew = hstate * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C.float(), hnew)
    y = y + x.float() * D.float()[:, None]
    return hnew, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Reference (sequential) implementation for tests
# ---------------------------------------------------------------------------

def ssd_reference(x, dt, A, B, C, D):
    """O(S) sequential recurrence — the oracle for ssd_scan."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    hstate = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        hstate, y = ssd_decode_step(hstate, x[:, t], dt[:, t], A,
                                    B[:, t], C[:, t], D)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype)
