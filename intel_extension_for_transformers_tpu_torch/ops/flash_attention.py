"""Flash attention (online softmax, O(T) memory), with the hand-written K4.

Port of `intel_extension_for_transformers_tpu/ops/flash_attention.py`.
`flash_attention` takes the JAX package's (B, T, H, D) layout and GQA
(H a multiple of Hkv; query head h reads KV head h // (H / Hkv)). On a CUDA
tensor it launches K4, `csrc/flash_attention.cu`, or raises; on a CPU tensor
it runs `flash_attention_plain`, the kernel's plain version. K4 routes by
dtype inside its one launch: bf16 runs on the tensor cores (mma.sync, P kept
as a bf16 pair of ~16 bits), f32 on the SIMT first version. The Pallas
kernel's `block_q` / `block_k` tiling knobs are TPU tiling and have no
counterpart: K4 picks its own tiles.

The masks are the Pallas kernel's: key ki is valid when ki < S and, if
causal, ki <= qi + q_offset; a masked logit is -1e30 (not -inf) and the
output is acc / max(l, 1e-30). q_offset must be >= 0 (the JAX callers pass
0, or the cached length for chunked prefill), so no row is fully masked.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, T, H, D), k = v (B, S, Hkv, D); got {q.shape}, {k.shape}, {v.shape}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] < 1:
        raise ValueError("flash attention needs at least one key")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention_plain(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """K4's plain PyTorch version: the whole (T, S) score matrix in f32."""
    _check(q, k, v, q_offset)
    T, H, D = q.shape[1:]
    S, Hkv = k.shape[1:3]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    rep = H // Hkv
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        qi = torch.arange(T, device=q.device)[:, None] + q_offset
        ki = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), vf)
    return out.to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch K4 on CUDA tensors, all f32 or all bf16 → (B, T, H, D) in q's dtype."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    _check(q, k, v, q_offset)
    B, T, H, D = q.shape
    S, Hkv = k.shape[1:3]
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"K4 runs on a CUDA device, got {dev}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"K4 takes q, k, v all f32 or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"K4 takes head_dim <= {MAX_HEAD_DIM} and a multiple of 8, got {D}")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # the bf16 kernel stages rows with 16-byte copies: an offset view is copied
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    if B == 0 or T == 0 or H == 0:
        return out
    status = load_kernels().itx_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, T, S, H, Hkv, D, float(scale), int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """→ (B, T, H, D). Drop-in for `ops.layers.attention` on long sequences.

    K4 on a CUDA tensor (or it raises); the plain version on a CPU tensor."""
    fn = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
    return fn(q, k, v, causal=causal, scale=scale, q_offset=q_offset)
