"""Plain PyTorch reference of the int8 forward a CIM chip computes.

Independent of the program under test: it imports torch and the
standard library only, and takes from the caller nothing but the seeded
weights, the seeded inputs and the configuration file's numbers.  It
works out the requantisation shifts itself, from one calibration image.

Semantics, per the configuration's crossbar:

* activations and weights are signed ``act_bits`` / ``weight_bits``
  integers, stored offset-encoded (``v + 2**(bits-1)``) in the crossbar;
* an MVM presents the input bit-serially, ``dac_bits`` per phase, against
  weights held as ``cell_bits`` slices; ``parallel_row`` consecutive rows
  of the weight matrix are summed in one analog read, counted from row 0,
  and each read is digitised by an ``adc_bits`` ADC that saturates at
  ``2**adc_bits - 1``;
* phases, slices and row groups are shift-added; the rank-1 offset
  correction is applied digitally;
* every CIM layer and every Add, and any layer that states
  ``"requant": true``, requantises its int accumulator to int8 by an
  arithmetic right shift and a clamp to [-128, 127]; the shift is the
  least that brings the calibration image's largest magnitude under 128.

An op this module does not know is looked up in the ``ops`` a caller
passes (a configuration family's ``OPS``): ``fn(xs, layer)`` from the
layer's input tensors to its output, plain torch like this module.

Where the ADC can never saturate the MVM is the exact integer product.
Every float64 sum here stays far inside float64's exact-integer range.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Crossbar:
    """The compute parameters a configuration file states."""

    act_bits: int
    weight_bits: int
    dac_bits: int
    cell_bits: int
    parallel_row: int
    adc_bits: int

    @classmethod
    def from_config(cls, cfg: Dict) -> "Crossbar":
        xb = cfg["crossbar"]
        return cls(**{f.name: int(xb[f.name])
                      for f in dataclasses.fields(cls)})

    @property
    def phases(self) -> int:
        return math.ceil(self.act_bits / self.dac_bits)

    @property
    def slices(self) -> int:
        return math.ceil(self.weight_bits / self.cell_bits)

    def exact(self, rows: Optional[int] = None) -> bool:
        """True when no analog read can saturate: a read of
        ``parallel_row`` rows, or of ``rows`` where that is fewer."""
        pr = self.parallel_row if rows is None \
            else min(self.parallel_row, rows)
        vmax = pr * ((1 << self.dac_bits) - 1) * ((1 << self.cell_bits) - 1)
        return vmax <= (1 << self.adc_bits) - 1


def pick_shift(y: torch.Tensor) -> int:
    """Least right shift that brings ``max |y|`` to 127 or under."""
    m = int(y.abs().max()) if y.numel() else 0
    if m <= 127:
        return 0
    return max(0, int(math.ceil(math.log2((m + 1) / 127.0))))


def requant(y: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.clamp(y >> shift, -128, 127)


def quantize(v: torch.Tensor, bits: int, keep: int) -> torch.Tensor:
    """``v`` (signed ``bits``-bit ints) on the grid of its top ``keep``
    bits: the operand a ``keep``-bit datapath would carry."""
    drop = bits - keep
    return v if drop <= 0 else (v >> drop) << drop


class Mvm:
    """Signed (..., R) x (R, C) -> (..., C) int64 products under one
    crossbar, for one weight matrix (its planes built once): every
    leading dimension of the input is a row of the product."""

    def __init__(self, w: torch.Tensor, xb: Crossbar, keep_bits: int):
        self.xb = xb
        self.keep = keep_bits
        w = quantize(w.to(torch.int64), xb.weight_bits, keep_bits)
        self.r, self.c = w.shape
        self.exact = xb.exact(self.r)
        if self.exact:
            self.w = w.to(torch.float64)
            return
        self.pr = min(xb.parallel_row, self.r)
        self.groups = math.ceil(self.r / self.pr)
        ow = 1 << (xb.weight_bits - 1)
        w_u = w + ow
        self.sw = w_u.sum(dim=0, keepdim=True)                  # (1, C)
        w_u = F.pad(w_u, (0, 0, 0, self.groups * self.pr - self.r))
        mask = (1 << xb.cell_bits) - 1
        # (S, G, pr, C): slice planes, row groups on the batch axis
        self.w_planes = torch.stack([
            ((w_u >> (s * xb.cell_bits)) & mask).to(torch.float64)
            .reshape(self.groups, self.pr, self.c)
            for s in range(xb.slices)])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        return self._rows(x.reshape(-1, self.r)).reshape(*lead, self.c)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """(N, R) -> (N, C)."""
        xb = self.xb
        x = quantize(x.to(torch.int64), xb.act_bits, self.keep)
        if self.exact:
            return (x.to(torch.float64) @ self.w).to(torch.int64)
        n = x.shape[0]
        ox = 1 << (xb.act_bits - 1)
        ow = 1 << (xb.weight_bits - 1)
        x_u = x + ox
        sx = x_u.sum(dim=1, keepdim=True)                       # (N, 1)
        x_u = F.pad(x_u, (0, self.groups * self.pr - self.r))
        mask = (1 << xb.dac_bits) - 1
        adc_max = float((1 << xb.adc_bits) - 1)
        y_u = torch.zeros((n, self.c), dtype=torch.float64, device=x.device)
        for p in range(xb.phases):
            xp = ((x_u >> (p * xb.dac_bits)) & mask).to(torch.float64) \
                .reshape(n, self.groups, self.pr).transpose(0, 1)   # (G,N,pr)
            for s in range(xb.slices):
                part = torch.bmm(xp, self.w_planes[s])               # (G,N,C)
                part = torch.clamp(part, max=adc_max).sum(dim=0)
                y_u += part * float(1 << (p * xb.dac_bits
                                          + s * xb.cell_bits))
        y_u = y_u.to(torch.int64)
        return y_u - ow * sx - ox * self.sw + self.r * ox * ow


# -- the model's operators -----------------------------------------------------

def conv(x: torch.Tensor, mvm: Mvm, layer: Dict) -> torch.Tensor:
    """(N, Cin, H, W) int64 -> (N, Cout, OH, OW) int64 accumulators; the
    weight matrix's rows are in (cin, ky, kx) order."""
    n, _, h, w = x.shape
    k, s, p = layer["k"], layer["stride"], layer["pad"]
    oh = (h + 2 * p - k) // s + 1
    ow = (w + 2 * p - k) // s + 1
    cols = F.unfold(x.to(torch.float64), k, padding=p, stride=s)  # (N,R,L)
    rows = cols.transpose(1, 2).reshape(n * oh * ow, -1).to(torch.int64)
    y = mvm(rows)                                                  # (NL, C)
    return y.reshape(n, oh * ow, -1).transpose(1, 2) \
        .reshape(n, -1, oh, ow)


def maxpool(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    y = F.max_pool2d(x.to(torch.float64), layer["k"], layer["stride"],
                     layer["pad"])
    return y.to(torch.int64)


def forward(layers: Sequence[Dict], mvms: Dict[str, Mvm], x: torch.Tensor,
            shifts: Optional[Dict[str, int]] = None,
            outputs: Sequence[str] = (), ops: Optional[Dict] = None
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Run ``layers`` on ``x`` (N, ...) int ints, with ``ops`` (op name
    to ``fn(xs, layer)``) for the ops this module does not know.  Without
    ``shifts`` this is the calibration pass: each requantising layer
    picks its shift from what it sees.  Returns (the tensors named in
    ``outputs``, by default the last layer's output, by name; the
    shifts)."""
    calibrating = shifts is None
    shifts = {} if shifts is None else shifts
    ops = ops or {}
    t: Dict[str, torch.Tensor] = {"input": x.to(torch.int64)}
    for layer in layers:
        op = layer["op"]
        xs = [t[name] for name in layer["inputs"]]
        if op == "conv":
            y = conv(xs[0], mvms[layer["name"]], layer)
        elif op == "fc":
            y = mvms[layer["name"]](xs[0])
        elif op == "add":
            y = xs[0] + xs[1]
        elif op == "relu":
            y = torch.clamp(xs[0], min=0)
        elif op == "maxpool":
            y = maxpool(xs[0], layer)
        elif op == "gap":
            hw = xs[0].shape[2] * xs[0].shape[3]
            y = torch.div(xs[0].sum(dim=(2, 3)), hw, rounding_mode="floor")
        elif op == "flatten":
            y = xs[0].reshape(xs[0].shape[0], -1)
        elif op in ops:
            y = ops[op](xs, layer)
        else:
            raise ValueError(f"no reference for {op!r}")
        if op in ("conv", "fc", "add") or layer.get("requant"):
            if calibrating:
                shifts[layer["name"]] = pick_shift(y)
            y = requant(y, shifts[layer["name"]])
        t[layer["output"]] = y
    return {name: t[name] for name in outputs or [layers[-1]["output"]]}, \
        shifts


def weight_shapes(layers: Sequence[Dict]) -> List[Tuple[str, Tuple[int, int]]]:
    """(name, (R, C)) of every crossbar layer, in order."""
    out = []
    for layer in layers:
        if layer["op"] == "conv":
            out.append((layer["name"], (layer["cin"] * layer["k"] ** 2,
                                        layer["cout"])))
        elif layer["op"] == "fc":
            out.append((layer["name"], (layer["cin"], layer["cout"])))
    return out


def run(layers: Sequence[Dict], weights: Dict[str, torch.Tensor],
        calib: torch.Tensor, images: torch.Tensor, xb: Crossbar, *,
        device, block: int, outputs: Sequence[str],
        keep_bits: Optional[int] = None,
        ops: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The tensors named in ``outputs`` for ``images`` (N, ...), in blocks
    of ``block`` images on ``device``: shifts from ``calib`` (one image),
    then the forward, with ``ops`` for the ops this module does not know.
    ``keep_bits`` below ``act_bits`` computes every crossbar operand on a
    narrower grid (the control).  Returns int64 on the CPU, by name."""
    keep = xb.act_bits if keep_bits is None else keep_bits
    mvms = {name: Mvm(weights[name].to(device), xb, keep)
            for name, _ in weight_shapes(layers)}
    with torch.no_grad():
        _, shifts = forward(layers, mvms, calib[None].to(device), ops=ops)
        parts = [forward(layers, mvms, images[i:i + block].to(device),
                         shifts, outputs, ops)[0]
                 for i in range(0, images.shape[0], block)]
    return {name: torch.cat([p[name].cpu() for p in parts])
            for name in outputs}
