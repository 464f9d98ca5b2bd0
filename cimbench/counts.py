"""Operations and bytes from shapes, and the card's published peaks.

The yardstick of the roofline and mfu metrics.  Counts come from the
configuration's layer list and the launches' shapes, the same whatever
implements them.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit
PEAKS = {
    "NVIDIA H100": {"int8_ops_per_s": 1979e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card named ``device_name`` (a prefix match)."""
    for prefix, p in PEAKS.items():
        if device_name.startswith(prefix):
            return p
    raise KeyError(f"no published peaks for {device_name!r}")


def operand_bytes(xb) -> int:
    """Bytes of one stored crossbar operand: one when every phase and
    slice lies in the low byte, else four."""
    xbits = xb.phases * xb.dac_bits
    wbits = xb.slices * xb.cell_bits
    return 1 if max(xbits, wbits) <= 8 else 4


def launch_bound_s(shapes: Iterable[Tuple[int, int, int, int]], xb,
                   pk: Dict[str, float]) -> float:
    """Least time of crossbar-MVM launches at ``shapes`` ((T, M, R, C)
    each): per launch the larger of its bytes (x and w read once, the
    int32 output written once) over the memory rate and its plane
    operations ``2*T*M*C*R*P*S`` over the int8 rate, summed."""
    eb = operand_bytes(xb)
    total = 0.0
    for t, m, r, c in shapes:
        nbytes = (t * m * r + t * r * c) * eb + t * m * c * 4
        ops = 2 * t * m * c * r * xb.phases * xb.slices
        total += max(nbytes / pk["hbm_bytes_per_s"],
                     ops / pk["int8_ops_per_s"])
    return total


def windows(layers: Sequence[Dict], in_shape) -> Dict[str, int]:
    """MVM rows one image gives each crossbar layer: output positions of
    a convolution, a fully connected layer's ``rows`` (1 where it states
    none; a Gemm over tokens states one row a token).  ``in_shape`` is an
    image's (C, H, W) or any other input's shape."""
    hw = {"input": tuple(in_shape[1:])} if len(in_shape) == 3 else {}
    out = {}
    for layer in layers:
        src = hw.get(layer["inputs"][0])
        if layer["op"] in ("conv", "maxpool"):
            k, s, p = layer["k"], layer["stride"], layer["pad"]
            oh = (src[0] + 2 * p - k) // s + 1
            ow = (src[1] + 2 * p - k) // s + 1
            hw[layer["output"]] = (oh, ow)
            if layer["op"] == "conv":
                out[layer["name"]] = oh * ow
        elif layer["op"] == "fc":
            out[layer["name"]] = layer.get("rows", 1)
        elif src is not None and layer["op"] in ("relu", "add"):
            hw[layer["output"]] = src
    return out


def mvm_ops_per_image(layers: Sequence[Dict], in_shape, xb) -> int:
    """Operations one image's MVMs need on this crossbar: the plane
    products ``2*M*R*C*P*S`` where its reads can saturate, the plain
    product ``2*M*R*C`` where its ADC is exact."""
    wins = windows(layers, in_shape)
    planes = 1 if xb.exact() else xb.phases * xb.slices
    total = 0
    for layer in layers:
        if layer["op"] not in ("conv", "fc"):
            continue
        r = layer["cin"] * (layer["k"] ** 2 if layer["op"] == "conv" else 1)
        c = layer["cout"]
        total += 2 * wins[layer["name"]] * r * c * planes
    return total


def percent(num: float, den: float):
    """``100 * num / den``, or ``None`` where there is nothing to divide."""
    if not den or num is None or math.isnan(num):
        return None
    return 100.0 * num / den
