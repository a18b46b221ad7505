"""Weight-only-quantized matmul, with the hand-written int4 GEMM (K1).

Port of `intel_extension_for_transformers_tpu/ops/quant_matmul.py`:

1. `woq_matmul_ref`: dequantize to f32, then an f32 matmul. The oracle.
2. `woq_matmul`: the reference's dispatch. At M >= 1024 rows the weight is
   dequantized once into the compute dtype and multiplied with
   `torch.matmul` (the JAX package's dequantize-once branch; M >= 1024 was
   chosen on a TPU and has not been re-measured on the H100). Below that a
   4-bit weight goes to K1, `csrc/woq_int4.cu`, which never writes the
   dequantized weight to device memory. K1 takes every shape the packing
   allows, so there is no fallback for unfriendly shapes.
3. `woq_linear` and the `WOQLinear` module: a linear layer over a
   `QuantizedTensor`, held as buffers.

Compute is f32 when x is f32 (full f32, no TF32) and bf16 otherwise; the
accumulator is always f32. The int8 GEMM (K2) is not ported yet: an int8
weight runs on the CPU through the plain path and raises on a CUDA tensor.
No backward is defined; the port serves inference only so far.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional

import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.ops.codebooks import get_codebook
from intel_extension_for_transformers_tpu_torch.ops.packing import (
    QuantizedTensor,
    dequantize,
    unpack_int4,
)

DEQUANT_ONCE_MIN_M = 1024
_SCHEME_IDS = {"sym": 0, "asym": 1, "codebook": 2}


def woq_matmul_ref(
    x: torch.Tensor, qt: QuantizedTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Dequantize-then-matmul ground truth in f32. x: (..., K) → (..., N)."""
    w = dequantize(qt, dtype=torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype or x.dtype)


def woq_matmul_plain(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """K1's plain PyTorch version, with the kernel's rounding.

    x2 (M, K) in the compute dtype. The scale (and zero point) are cast to
    the compute dtype and q·s or (q−z)·s is taken in that dtype, as the
    Pallas kernels do; the product accumulates in f32. Also covers int8
    weights, whose kernel (K2) is not ported.
    """
    cd = x2.dtype
    g = qt.group_size
    if qt.bits == 4:
        idx = unpack_int4(qt.data, signed=qt.scheme == "sym" and not qt.is_codebook)
    else:
        idx = qt.data
    if qt.is_codebook:
        cb = torch.as_tensor(get_codebook(qt.weight_dtype), device=idx.device)
        q = cb[idx.to(torch.int64)].to(cd)
    elif qt.scheme == "asym":  # stored as wrapped unsigned values
        q = (idx.to(torch.int32) & 0xFF).to(cd)
    else:
        q = idx.to(cd)
    q = q.reshape(qt.K // g, g, qt.N)
    s = qt.scales.to(torch.float32).to(cd)[:, None, :]
    if qt.scheme == "asym":
        q = q - qt.zeros.to(torch.float32).to(cd)[:, None, :]
    w = (q * s).reshape(qt.K, qt.N)
    out = torch.matmul(x2.to(torch.float32), w.to(torch.float32))
    return out.to(out_dtype)


def woq_int4_cuda(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Launch K1 on x2 (M, K), f32 or bf16, contiguous, on a CUDA device."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    M, K = x2.shape
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on a CUDA device, got {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes f32 or bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 writes f32 or bf16, got {out_dtype}")
    if qt.bits != 4 or qt.data.shape != (K // 2, qt.N) or qt.data.device != dev:
        raise ValueError("K1 needs a khalf int4 weight of shape (K/2, N) on x's device")
    if (K // 2) % qt.group_size or qt.scales.shape != (K // qt.group_size, qt.N):
        raise ValueError(f"group_size {qt.group_size} must divide K/2 = {K // 2}")
    x2 = x2.contiguous()
    data = qt.data.contiguous()
    scales = qt.scales.to(torch.float32).contiguous()
    if qt.is_codebook:
        scheme = "codebook"
        codebook = torch.as_tensor(get_codebook(qt.weight_dtype), device=dev)
    else:
        scheme = qt.scheme
        codebook = scales  # unread by the kernel
    zeros = qt.zeros.to(torch.float32).contiguous() if scheme == "asym" else scales
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    if M == 0 or qt.N == 0:
        return out
    status = load_kernels().itx_woq_int4(
        x2.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        codebook.data_ptr(), out.data_ptr(),
        M, qt.N, K, qt.group_size, _SCHEME_IDS[scheme],
        int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_woq_int4")
    woq_int4_cuda.launches += 1
    return out


woq_int4_cuda.launches = 0


def woq_matmul(
    x: torch.Tensor, qt: QuantizedTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """x (..., K) @ dequant(qt) (K, N) → (..., N).

    On a CUDA tensor a 4-bit weight at M < 1024 launches K1 or raises; the
    plain version runs only for a CPU tensor.
    """
    if qt.pre_scale is not None:
        # AWQ/TEQ/SmoothQuant folding: diag(pre_scale) @ W applied to x instead
        x = x * qt.pre_scale.to(x.dtype)
    out_dtype = out_dtype or x.dtype
    batch_shape = x.shape[:-1]
    K = x.shape[-1]
    if K != qt.K:
        raise ValueError(f"x last dim {K} != quantized weight K {qt.K}")
    M = math.prod(batch_shape)
    cd = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    x2 = x.reshape(M, K).to(cd)

    if M >= DEQUANT_ONCE_MIN_M:
        # compute-bound regime: decode the weight once, then a plain matmul
        out = torch.matmul(x2, dequantize(qt, dtype=cd))
    elif x2.device.type == "cpu":
        out = woq_matmul_plain(x2, qt, out_dtype)
    elif qt.bits == 4:
        out = woq_int4_cuda(x2, qt, out_dtype)
    else:
        raise NotImplementedError(
            "the int8 WOQ kernel (K2, quant_matmul.py::_woq_kernel_8bit) is not ported"
        )
    return out.to(out_dtype).reshape(*batch_shape, qt.N)


def woq_linear(
    x: torch.Tensor,
    qt: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Linear layer on a quantized weight."""
    out = woq_matmul(x, qt, out_dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class WOQLinear(nn.Module):
    """Inference linear layer over a packed weight.

    The packed data, scales, zero points and pre-scale are buffers, so
    `.to(device)` and `state_dict()` carry them; the layout metadata are plain
    attributes. Replaces `nn.Linear` in a quantized model
    (`quantization.quantize_model`).
    """

    def __init__(self, qt: QuantizedTensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("data", qt.data)
        self.register_buffer("scales", qt.scales)
        self.register_buffer("zeros", qt.zeros)
        self.register_buffer("pre_scale", qt.pre_scale)
        self.register_buffer("bias", bias)
        self._meta = replace(qt, data=None, scales=None, zeros=None, pre_scale=None)

    @property
    def qt(self) -> QuantizedTensor:
        return replace(
            self._meta, data=self.data, scales=self.scales, zeros=self.zeros,
            pre_scale=self.pre_scale,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return woq_linear(x, self.qt, self.bias)

    def extra_repr(self) -> str:
        m = self._meta
        return f"K={m.K}, N={m.N}, {m.weight_dtype}/{m.scheme}, group_size={m.group_size}"
