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

* **w32 decode layout.** `to_decode_layout` repacks an int4 khalf tensor
  into int32 words of 8 biased nibbles (`_khalf_to_w32`), the layout the w32
  decode GEMM (K3, `csrc/woq_w32.cu`) reads; `prepare_for_inference` does it
  once for every eligible layer of a model before serving. The words are
  bit-identical to the JAX package's.

Supported dtypes: "int4"/"int3"/"int2" (sym or asym, in the nibble layout),
"int8" (unpacked), "nf4"/"fp4" (codebook indices, absmax scale per group).
The stacked (MoE) variants are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
from torch import nn

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
    # "khalf": int8 (K//2, N) nibble half-split; "w32": int32 (Kp//8, N)
    # decode words, scales and zeros padded to Kp//group_size rows
    layout: str = "khalf"

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

    # contiguous buffers: w is often a transposed view (nn.Linear's weight.T),
    # whose stride order elementwise ops keep, and the kernels read row-major
    return QuantizedTensor(
        data=data.contiguous(),
        scales=scales.to(scale_dtype).contiguous(),
        zeros=None if zeros is None else zeros.contiguous(),
        weight_dtype=weight_dtype,
        scheme="sym" if weight_dtype in ("nf4", "fp4", "fp4_e2m1") else scheme,
        group_size=group_size,
        K=K,
        N=N,
    )


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reconstruct the (K, N) float weight, computed in f32, cast to `dtype`."""
    if qt.layout == "w32":
        qt = from_decode_layout(qt)
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


# ---------------------------------------------------------------------------
# w32 decode layout
# ---------------------------------------------------------------------------


def decode_layout_pad(K: int, group_size: int) -> int:
    """Padded K of the w32 layout: a multiple of lcm(512, 8 * group_size).

    512 rows are one 64-word block of the layout; the JAX package's kernel
    also wants a multiple of 8 scale groups per K step. Padded rows hold zero
    nibbles and meet zero-padded activations, so they add nothing."""
    unit = max(512, 8 * group_size)
    return (K + unit - 1) // unit * unit


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → int32 with the same 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _khalf_to_w32(data: torch.Tensor, K: int, group_size: int, scheme: str) -> torch.Tensor:
    """int8 (K//2, N) khalf → int32 (Kp//8, N) words.

    Word kw of each 512-row block holds slot s at bits [4s, 4s + 4): slot
    s < 4 is row 128 s + 2 kw and slot s >= 4 is row 128 (s - 4) + 2 kw + 1.
    A sym nibble is biased to [0, 15] by flipping its top bit (v ^ 8 = v + 8).
    """
    N = data.shape[1]
    p = data.to(torch.int64)
    nib = torch.cat([p & 0xF, (p >> 4) & 0xF], dim=0)  # (K, N) raw nibble bits
    if scheme == "sym":
        nib = nib ^ 8
    Kp = decode_layout_pad(K, group_size)
    if Kp != K:
        nib = torch.cat([nib, nib.new_zeros(Kp - K, N)], dim=0)
    nib = nib.reshape(Kp // 512, 4, 64, 2, N)  # [block, j, kw, half, n]
    words = torch.zeros((Kp // 512, 64, N), dtype=torch.int64, device=data.device)
    for j in range(4):
        for half in range(2):
            words |= nib[:, j, :, half, :] << (4 * (j + 4 * half))
    return _to_int32_bits(words.reshape(Kp // 8, N))


def w32_nibbles(words: torch.Tensor) -> torch.Tensor:
    """int32 (Kp//8, N) words → (Kp, N) int32 biased nibbles in natural row order."""
    N = words.shape[1]
    Kp = words.shape[0] * 8
    w = words.to(torch.int32).reshape(Kp // 512, 1, 64, 1, N)
    shifts = 4 * (torch.arange(4, device=words.device)[:, None]
                  + 4 * torch.arange(2, device=words.device)[None, :])  # [j, half]
    nib = (w >> shifts.to(torch.int32)[None, :, None, :, None]) & 0xF
    return nib.reshape(Kp, N)


def _w32_to_khalf(words: torch.Tensor, K: int, scheme: str) -> torch.Tensor:
    nib = w32_nibbles(words)[:K]
    if scheme == "sym":
        nib = nib ^ 8
    return _wrap_int8((nib[K // 2 :] << 4) | nib[: K // 2])


def to_decode_layout(qt: QuantizedTensor) -> QuantizedTensor:
    """Repack an int4 khalf tensor into the w32 decode layout.

    Scales and zeros get zero rows up to Kp//group_size. int8, codebook and
    already-w32 tensors come back unchanged (they keep the khalf kernels)."""
    if qt.layout != "khalf" or qt.bits != 4 or qt.is_codebook or qt.data.ndim != 2:
        return qt
    Kp = decode_layout_pad(qt.K, qt.group_size)
    gpad = Kp // qt.group_size - qt.scales.shape[0]

    def pad_rows(t):
        if t is None or not gpad:
            return t
        return torch.cat([t, t.new_zeros(gpad, t.shape[1])], dim=0)

    return replace(
        qt,
        data=_khalf_to_w32(qt.data, qt.K, qt.group_size, qt.scheme),
        scales=pad_rows(qt.scales),
        zeros=pad_rows(qt.zeros),
        layout="w32",
    )


def from_decode_layout(qt: QuantizedTensor) -> QuantizedTensor:
    """Inverse of `to_decode_layout` (drops the K and scale-row padding)."""
    if qt.layout != "w32":
        return qt
    G = qt.K // qt.group_size
    return replace(
        qt,
        data=_w32_to_khalf(qt.data, qt.K, qt.scheme),
        scales=qt.scales[:G],
        zeros=None if qt.zeros is None else qt.zeros[:G],
        layout="khalf",
    )


@torch.no_grad()
def prepare_for_inference(model: nn.Module) -> nn.Module:
    """Repack every eligible `WOQLinear` of `model` into the w32 layout, in
    place. Call once on a loaded model before serving; returns `model`."""
    from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import WOQLinear

    for module in model.modules():
        if isinstance(module, WOQLinear):
            module.set_qt(to_decode_layout(module.qt))
    return model
