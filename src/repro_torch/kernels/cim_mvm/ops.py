"""Public entry points of the crossbar MVM, routed by the backend registry.

``cim_mvm``        — unsigned bit-sliced crossbar MVM.
``cim_mvm_tiles``  — tile-batched MVM (the executor fast path).
``cim_mvm_signed`` — signed ints via offset encoding (the standard CIM
                     trick: store w + 2^(wb-1), subtract the rank-1
                     correction digitally).
``cim_mvm_params`` — derive the precision/row parameters from a CIMArch.

Each entry point resolves a :class:`~repro_torch.kernels.backend.KernelRoute`
from the device of its tensors (the CUDA kernel on a Hopper card, the
plain version on the CPU) unless the caller forces ``mode=``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import backend
from . import kernel, ref


@dataclasses.dataclass(frozen=True)
class CimMvmParams:
    act_bits: int = 8
    weight_bits: int = 8
    dac_bits: int = 1
    cell_bits: int = 2
    parallel_row: int = 8
    adc_bits: int = 8

    @property
    def exact(self) -> bool:
        """True if the ADC never saturates (pure integer matmul)."""
        need = ref.exact_adc_bits(self.act_bits, self.weight_bits,
                                  self.dac_bits, self.cell_bits,
                                  self.parallel_row)
        return self.adc_bits >= need


def cim_mvm_params(arch, rows_used: Optional[int] = None) -> CimMvmParams:
    """Build params from a core.abstraction.CIMArch."""
    xb = arch.xb
    pr = xb.parallel_row
    if rows_used is not None:
        pr = min(pr, rows_used)
    return CimMvmParams(act_bits=arch.act_bits, weight_bits=arch.weight_bits,
                        dac_bits=xb.dac_bits, cell_bits=xb.cell_precision,
                        parallel_row=pr, adc_bits=xb.adc_bits)


def _ref_kwargs(params: CimMvmParams) -> dict:
    return dict(act_bits=params.act_bits, weight_bits=params.weight_bits,
                dac_bits=params.dac_bits, cell_bits=params.cell_bits,
                parallel_row=params.parallel_row, adc_bits=params.adc_bits)


def _operand(a: torch.Tensor, params: CimMvmParams) -> torch.Tensor:
    """The kernel's operand form: ``kernel.operand_dtype``, contiguous."""
    return a.to(kernel.operand_dtype(params)).contiguous()


def _mvm(x_u: torch.Tensor, w_u: torch.Tensor, params: CimMvmParams,
         mode: str) -> torch.Tensor:
    if mode == "torch":
        return ref.cim_mvm_ref(x_u, w_u, **_ref_kwargs(params))
    return kernel.cim_mvm_cuda(_operand(x_u, params), _operand(w_u, params),
                               params)


def cim_mvm(x_u: torch.Tensor, w_u: torch.Tensor, params: CimMvmParams, *,
            mode: Optional[str] = None) -> torch.Tensor:
    """Unsigned crossbar MVM: (M,R) x (R,C) -> (M,C) int32 (a 1-D x gives
    a 1-D result)."""
    route = backend.resolve("cim_mvm", mode, device=x_u.device)
    if x_u.dim() == 1:
        return _mvm(x_u[None], w_u, params, route.mode)[0]
    return _mvm(x_u, w_u, params, route.mode)


def cim_mvm_tiles(x_u: torch.Tensor, w_u: torch.Tensor,
                  params: CimMvmParams, *,
                  mode: Optional[str] = None) -> torch.Tensor:
    """Tile-batched unsigned crossbar MVM: (T,M,R) x (T,R,C) -> (T,M,C).

    The batched entry point of the trace-lowered executor: all crossbar
    tiles of one dispatch ride the leading tile axis and run in one
    kernel launch.  Every tile shares the bit-sliced, parallel-row-
    grouped, ADC-saturating semantics of ``cim_mvm``.
    """
    route = backend.resolve("cim_mvm_tiles", mode, device=x_u.device)
    if route.mode == "torch":
        return ref.cim_mvm_ref_tiles(x_u, w_u, **_ref_kwargs(params))
    return kernel.cim_mvm_tiles_cuda(_operand(x_u, params),
                                     _operand(w_u, params), params)


def cim_mvm_signed(x_i: torch.Tensor, w_i: torch.Tensor,
                   params: CimMvmParams, *,
                   mode: Optional[str] = None) -> torch.Tensor:
    """Signed MVM via offset encoding.

    x in [-2^(ab-1), 2^(ab-1)), w likewise; stored as x+ox / w+ow
    unsigned; the rank-1 offset correction is applied digitally (exact
    when the ADC does not saturate).
    """
    route = backend.resolve("cim_mvm_signed", mode, device=x_i.device)
    squeeze = x_i.dim() == 1
    if squeeze:
        x_i = x_i[None]
    ox = 1 << (params.act_bits - 1)
    ow = 1 << (params.weight_bits - 1)
    x_u = x_i.to(torch.int32) + ox
    w_u = w_i.to(torch.int32) + ow
    y_u = _mvm(x_u, w_u, params, route.mode)
    r = x_i.shape[-1]
    sx = x_u.sum(dim=-1, keepdim=True, dtype=torch.int32)      # (M,1)
    sw = w_u.sum(dim=0, keepdim=True, dtype=torch.int32)       # (1,C)
    y = y_u - ow * sx - ox * sw + r * ox * ow
    return y[0] if squeeze else y
