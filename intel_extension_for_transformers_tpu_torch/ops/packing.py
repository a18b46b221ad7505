"""Group-wise low-bit weight quantization and the khalf int4 packing.

Port of `intel_extension_for_transformers_tpu/ops/packing.py`. The packed
bytes, scales and zero points are bit-identical to the JAX package's for the
same float weight, so checkpoints and indexes move between the two packages
unchanged.

* **khalf int4 layout.** A (K, N) weight quantized to 4 bits is stored as one
  int8 array of shape (K//2, N): the low nibble holds rows [0, K/2), the high
  nibble rows [K/2, K). The int4 GEMM (`ops/quant_matmul.py`) pairs
  `x[:, :K/2]` with the low plane and `x[:, K/2:]` with the high plane.
* **Group-wise scales along K.** scales (and zero points for asymmetric
  schemes) have shape (K//group_size, N). group_size must divide K//2, so a
  group never straddles the half split.

Supported dtypes: "int4"/"int3"/"int2" (sym or asym, in the nibble layout),
"int8" (unpacked), "nf4"/"fp4" (codebook indices, absmax scale per group).
The w32 decode layout and the stacked (MoE) variants are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from intel_extension_for_transformers_tpu_torch.ops.codebooks import get_codebook

WEIGHT_DTYPES = ("int4", "int8", "nf4", "fp4", "fp4_e2m1", "int3", "int2")


@dataclass
class QuantizedTensor:
    """A packed, group-quantized 2-D weight of logical shape (K, N)."""

    data: torch.Tensor  # int8: (K//2, N) for 4-bit, (K, N) for int8
    scales: torch.Tensor  # (K//group_size, N), float32 or bfloat16
    zeros: Optional[torch.Tensor]  # (K//group_size, N) float, None if symmetric
    # per-input-channel activation pre-scale (AWQ/TEQ/SmoothQuant folding):
    # effective weight = diag(pre_scale) @ dequant(data)
    pre_scale: Optional[torch.Tensor] = None  # (K,)
    weight_dtype: str = "int4"
    scheme: str = "sym"
    group_size: int = 128
    K: int = 0
    N: int = 0

    @property
    def bits(self) -> int:
        return 8 if self.weight_dtype == "int8" else 4

    @property
    def is_codebook(self) -> bool:
        return self.weight_dtype in ("nf4", "fp4", "fp4_e2m1")


def _check_shapes(K: int, group_size: int, bits: int) -> None:
    if group_size <= 0:
        raise ValueError(f"group_size must be positive, got {group_size}")
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    if bits == 4:
        if K % 2:
            raise ValueError(f"4-bit packing needs even K, got {K}")
        if (K // 2) % group_size:
            raise ValueError(
                f"group_size={group_size} must divide K//2={K // 2} "
                "(groups may not straddle the half-split)"
            )


def _wrap_int8(v: torch.Tensor) -> torch.Tensor:
    """int32 values in [-128, 255] → int8 with two's-complement wrap."""
    v = v.to(torch.int32)
    return torch.where(v > 127, v - 256, v).to(torch.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack (K, N) int values in [-8, 15] into (K//2, N) int8, khalf layout."""
    K = q.shape[0]
    lo = q[: K // 2].to(torch.int32) & 0xF
    hi = q[K // 2 :].to(torch.int32) & 0xF
    return _wrap_int8((hi << 4) | lo)


def unpack_int4(packed: torch.Tensor, signed: bool) -> torch.Tensor:
    """Inverse of pack_int4 → (K, N) int8 (sign-extended if `signed`)."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    if signed:
        lo = (lo ^ 8) - 8
        hi = (hi ^ 8) - 8
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def _recip(qmax: float, like: torch.Tensor) -> torch.Tensor:
    """1/qmax as an f32 scalar tensor. XLA rewrites a division by a constant
    into a product with its f32 reciprocal; scales match the JAX package's bit
    for bit only if the port does the same."""
    return torch.tensor(1.0 / qmax, dtype=torch.float32, device=like.device)


def _grouped(w: torch.Tensor, group_size: int) -> torch.Tensor:
    K, N = w.shape
    return w.reshape(K // group_size, group_size, N)


def quantize_groupwise(
    w: torch.Tensor,
    weight_dtype: str = "int4",
    scheme: str = "sym",
    group_size: int = 128,
    scale_dtype: torch.dtype = torch.float32,
) -> QuantizedTensor:
    """RTN group quantization of a (K, N) weight (K = in_features).

    Same operations, in the same order and precision, as the JAX package's
    `quantize_groupwise`, so the packed bytes and scales match it bit for bit.
    """
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype!r} not in {WEIGHT_DTYPES}")
    K, N = w.shape
    bits = 8 if weight_dtype == "int8" else 4
    _check_shapes(K, group_size, bits)
    g = _grouped(w.to(torch.float32), group_size)  # (G, gs, N)
    zeros = None

    if weight_dtype in ("nf4", "fp4", "fp4_e2m1"):
        cb = torch.as_tensor(get_codebook(weight_dtype), device=w.device)
        absmax = g.abs().amax(dim=1, keepdim=True)  # (G, 1, N)
        scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
        normed = g / scales  # in [-1, 1]
        idx = (normed[..., None] - cb).abs().argmin(dim=-1)  # nearest entry
        data = pack_int4(idx.reshape(K, N))
        scales = scales[:, 0, :]
    elif scheme == "sym":
        qmax = {"int8": 127.0, "int4": 7.0, "int3": 3.0, "int2": 1.0}[weight_dtype]
        absmax = g.abs().amax(dim=1, keepdim=True)
        scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax * _recip(qmax, w))
        q = torch.clamp(torch.round(g / scales), -qmax - 1, qmax).reshape(K, N)
        data = pack_int4(q) if bits == 4 else q.to(torch.int8)
        scales = scales[:, 0, :]
    elif scheme == "asym":
        qmax = {"int8": 255.0, "int4": 15.0, "int3": 7.0, "int2": 3.0}[weight_dtype]
        wmin = g.amin(dim=1, keepdim=True)
        wmax = g.amax(dim=1, keepdim=True)
        rng = wmax - wmin
        scales = torch.where(rng == 0, torch.ones_like(rng), rng * _recip(qmax, w))
        zp = torch.round(-wmin / scales)  # in [0, qmax]
        q = torch.clamp(torch.round(g / scales) + zp, 0, qmax).reshape(K, N)
        data = pack_int4(q) if bits == 4 else _wrap_int8(q)
        zeros = zp[:, 0, :].to(scale_dtype)
        scales = scales[:, 0, :]
    else:
        raise ValueError(f"scheme {scheme!r} must be 'sym' or 'asym'")

    return QuantizedTensor(
        data=data,
        scales=scales.to(scale_dtype),
        zeros=zeros,
        weight_dtype=weight_dtype,
        scheme="sym" if weight_dtype in ("nf4", "fp4", "fp4_e2m1") else scheme,
        group_size=group_size,
        K=K,
        N=N,
    )


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reconstruct the (K, N) float weight, computed in f32, cast to `dtype`."""
    g = qt.group_size
    if qt.is_codebook:
        cb = torch.as_tensor(get_codebook(qt.weight_dtype), device=qt.data.device)
        idx = unpack_int4(qt.data, signed=False)
        vals = cb[idx.to(torch.int64)]
        w = (_grouped(vals, g) * qt.scales.to(torch.float32)[:, None, :]).reshape(qt.K, qt.N)
    else:
        if qt.bits == 4:
            q = unpack_int4(qt.data, signed=qt.scheme == "sym")
        else:
            q = qt.data
        if qt.scheme == "asym":  # stored as wrapped unsigned values
            q = q.to(torch.int32) & 0xFF
        qf = _grouped(q.to(torch.float32), g)
        if qt.scheme == "asym":
            qf = qf - qt.zeros.to(torch.float32)[:, None, :]
        w = (qf * qt.scales.to(torch.float32)[:, None, :]).reshape(qt.K, qt.N)
    if qt.pre_scale is not None:
        w = w * qt.pre_scale.to(torch.float32)[:, None]
    return w.to(dtype)
