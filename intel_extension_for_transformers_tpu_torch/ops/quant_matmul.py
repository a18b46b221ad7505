"""Weight-only-quantized matmul, with the hand-written GEMMs K1, K2 and K3.

Port of `intel_extension_for_transformers_tpu/ops/quant_matmul.py`:

1. `woq_matmul_ref`: dequantize to f32, then an f32 matmul. The oracle.
2. `woq_matmul`: the reference's dispatch. A weight in the w32 decode
   layout (`packing.prepare_for_inference`) goes to K3, `csrc/woq_w32.cu`,
   at every M, before any other branch, as the JAX package sends it to
   `_pallas_woq_w32`. For a khalf weight, at M >= 1024 rows the weight is
   dequantized once into the compute dtype and multiplied with
   `torch.matmul` (the JAX package's dequantize-once branch; M >= 1024 was
   chosen on a TPU and has not been re-measured on the H100). Below that a
   4-bit weight goes to K1, `csrc/woq_int4.cu`, and an int8 weight to K2,
   `csrc/woq_int8.cu`; neither writes the dequantized weight to device
   memory. K1, K2 and K3 take every shape the packing allows, so there is
   no fallback for unfriendly shapes.
3. `woq_linear` and the `WOQLinear` module: a linear layer over a
   `QuantizedTensor`, held as buffers.

Compute is f32 when x is f32 (full f32, no TF32) and bf16 otherwise; the
accumulator is always f32. No backward is defined; the port serves
inference only so far.
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
    w32_nibbles,
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
    """The plain PyTorch version of K1 (4-bit weights) and K2 (int8), with
    the kernels' rounding.

    x2 (M, K) in the compute dtype. The scale (and zero point) are cast to
    the compute dtype and q·s or (q−z)·s is taken in that dtype, as the
    Pallas kernels do; the product accumulates in f32.
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

K2_GEMV_MAX_M = 8  # K2 runs its GEMV kernel up to this many rows, tiles above
K2_TARGET_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs
_K2_TILE_K = 32  # the tiled kernel's K step


def int8_k_chunk(M: int, N: int, K: int, group_size: int) -> int:
    """Rows of K that one K2 block sums (K itself when K is not split).

    K is split until the blocks reach `K2_TARGET_BLOCKS`: on group
    boundaries for the GEMV (128 columns a block), on 32-row steps for the
    tiles (64 columns by 16 or 64 rows). Every split holds at least one row.
    """
    if M <= K2_GEMV_MAX_M:
        blocks, unit = -(-N // 128), group_size
    else:
        blocks, unit = -(-N // 64) * -(-M // (16 if M <= 16 else 64)), _K2_TILE_K
    want = -(-K2_TARGET_BLOCKS // blocks)
    if want <= 1:
        return K
    units = -(-K // unit)
    return min(-(-units // min(want, units)) * unit, K)


def woq_int8_cuda(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Launch K2 on x2 (M, K), f32 or bf16, on a CUDA device."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    M, K = x2.shape
    dev = x2.device
    g = qt.group_size
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on a CUDA device, got {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 takes f32 or bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 writes f32 or bf16, got {out_dtype}")
    if (qt.bits != 8 or qt.layout != "khalf" or qt.data.dtype != torch.int8
            or qt.data.shape != (K, qt.N) or qt.data.device != dev):
        raise ValueError("K2 needs an int8 weight of shape (K, N) on x's device")
    if K % g or qt.scales.shape != (K // g, qt.N):
        raise ValueError(f"group_size {g} must divide K = {K}")
    x2 = x2.contiguous()
    data = qt.data.contiguous()
    scales = qt.scales.to(torch.float32).contiguous()
    asym = qt.scheme == "asym"
    zeros = qt.zeros.to(torch.float32).contiguous() if asym else scales  # unread for sym
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    if M == 0 or qt.N == 0:
        return out
    gemv = M <= K2_GEMV_MAX_M
    k_chunk = int8_k_chunk(M, qt.N, K, g)
    splits = -(-K // k_chunk)
    part = torch.empty((splits, M, qt.N), dtype=torch.float32, device=dev) if splits > 1 else out
    vec = (qt.N % 4 == 0 and data.data_ptr() % 4 == 0
           and scales.data_ptr() % 16 == 0 and zeros.data_ptr() % 16 == 0)
    status = load_kernels().itx_woq_int8(
        x2.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), part.data_ptr(),
        M, qt.N, K, g, int(asym), int(gemv), k_chunk, int(vec),
        int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_woq_int8")
    woq_int8_cuda.launches += 1
    return out


woq_int8_cuda.launches = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def w32_m1_path(M: int, group_size: int) -> bool:
    """The JAX w32 kernel's branch gate: scale after a per-group dot (m1)
    when g >= 128 or the row tile min(round_up(M, 8), 256) is <= 32; else
    fold offset and scale into the weight before the dot."""
    tm = min(_round_up(max(M, 1), 8), 256)
    return group_size >= 128 or tm <= 32


def woq_w32_plain(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """K3's plain PyTorch version: both branches of the JAX w32 kernel.

    The words decode to 128 + v' (v' the biased nibble), exact in bf16.
    m1 branch: per-group dots of x (compute dtype) with 128 + v', summed in
    f32, times the f32 scale; then s * zc * sum(x_g) is subtracted in f32.
    Fold branch: ((128 + v') - zc) * s in f32, rounded to the compute dtype,
    then one dot with f32 accumulation (K1's rounding of q * s). The m1
    branch takes 256 rows at a time so its (G, rows, N) partials stay small.
    """
    M = x2.shape[0]
    g = qt.group_size
    cd = x2.dtype
    Kp = qt.data.shape[0] * 8
    x2 = torch.nn.functional.pad(x2, (0, Kp - x2.shape[1]))  # zero rows meet padded words
    scales = qt.scales.to(torch.float32)
    # the offset the biased words carry: 136 = 128 + 8 for sym, 128 + z for asym
    zc = qt.zeros.to(torch.float32) + 128.0 if qt.scheme == "asym" else torch.full_like(scales, 136.0)
    G = scales.shape[0]
    planes = w32_nibbles(qt.data).to(torch.float32) + 128.0  # (Kp, N), exact
    if w32_m1_path(M, g):
        wg = planes.reshape(G, g, qt.N)
        corr = scales * zc  # (G, N)
        outs = []
        for r in range(0, M, 256):
            xc = x2[r : r + 256].to(torch.float32)  # values of the compute dtype
            xg = xc.reshape(-1, G, g).transpose(0, 1)  # (G, rows, g)
            parts = torch.bmm(xg, wg)  # (G, rows, N) f32 partial sums
            acc = (parts * scales[:, None, :]).sum(dim=0)
            acc = acc - xg.sum(dim=2).T @ corr
            outs.append(acc)
        out = torch.cat(outs, dim=0) if outs else x2.new_zeros((0, qt.N), dtype=torch.float32)
    else:
        w = (planes.reshape(G, g, qt.N) - zc[:, None, :]) * scales[:, None, :]
        w = w.reshape(G * g, qt.N).to(cd).to(torch.float32)
        out = x2.to(torch.float32) @ w
    return out.to(out_dtype)


def woq_w32_cuda(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Launch K3 on x2 (M, K), f32 or bf16, on a CUDA device."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    M, K = x2.shape
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on a CUDA device, got {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 takes f32 or bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 writes f32 or bf16, got {out_dtype}")
    Kp = qt.data.shape[0] * 8
    g = qt.group_size
    if qt.layout != "w32" or qt.data.dtype != torch.int32 or qt.data.device != dev:
        raise ValueError("K3 needs a w32 weight (int32 words) on x's device")
    if Kp % 512 or Kp % g or qt.scales.shape != (Kp // g, qt.N) or K > Kp:
        raise ValueError(f"w32 words {tuple(qt.data.shape)} do not fit K={K}, g={g}")
    if g % 16:
        raise ValueError(f"K3 needs group_size % 16 == 0, got {g}")
    x2 = x2.contiguous()
    words = qt.data.contiguous()
    scales = qt.scales.to(torch.float32).contiguous()
    asym = qt.scheme == "asym"
    zeros = qt.zeros.to(torch.float32).contiguous() if asym else scales  # unread for sym
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    if M == 0 or qt.N == 0:
        return out
    status = load_kernels().itx_woq_w32(
        x2.data_ptr(), words.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
        M, qt.N, K, Kp, g, int(asym), int(w32_m1_path(M, g)),
        int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_woq_w32")
    woq_w32_cuda.launches += 1
    return out


woq_w32_cuda.launches = 0


def woq_matmul(
    x: torch.Tensor, qt: QuantizedTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """x (..., K) @ dequant(qt) (K, N) → (..., N).

    On a CUDA tensor a w32 weight launches K3 at every M, a khalf 4-bit
    weight at M < 1024 launches K1 and an int8 weight K2, or they raise; the
    plain versions run only for a CPU tensor.
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

    if qt.layout == "w32":
        # before the dequantize-once branch, as in the JAX package
        if x2.device.type == "cpu":
            out = woq_w32_plain(x2, qt, out_dtype)
        else:
            out = woq_w32_cuda(x2, qt, out_dtype)
    elif M >= DEQUANT_ONCE_MIN_M:
        # compute-bound regime: decode the weight once, then a plain matmul
        out = torch.matmul(x2, dequantize(qt, dtype=cd))
    elif x2.device.type == "cpu":
        out = woq_matmul_plain(x2, qt, out_dtype)
    elif qt.bits == 4:
        out = woq_int4_cuda(x2, qt, out_dtype)
    else:
        out = woq_int8_cuda(x2, qt, out_dtype)
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
        self.set_qt(qt)
        self.register_buffer("bias", bias)

    def set_qt(self, qt: QuantizedTensor) -> None:
        """Hold `qt` (e.g. after a layout change), replacing the buffers."""
        for name in ("data", "scales", "zeros", "pre_scale"):
            self.register_buffer(name, getattr(qt, name))
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
        return (f"K={m.K}, N={m.N}, {m.weight_dtype}/{m.scheme}, "
                f"group_size={m.group_size}, layout={m.layout}")
