"""Shared NN building blocks in plain PyTorch.

Port of the part of `intel_extension_for_transformers_tpu/ops/layers.py`
the BERT encoder and the Llama decoder use. No kernel sits here: the JAX
package leaves these to XLA fusion, and the port leaves them to PyTorch's
own operators; long no-cache attention goes to `ops/flash_attention.py`.
The linear-layer dispatch (`dense` on the weight's leaf type) becomes a
module swap: a quantized model holds `WOQLinear` where the float one holds
`nn.Linear` (`quantization.quantize_model`). LoRA, W8A8 and the H2O
attention-mass tap are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def layer_norm(x, scale, bias, eps: float = 1e-12):
    """LayerNorm with f32 statistics."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with f32 statistics."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def gelu(x, approximate: bool = True):
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return torch.nn.functional.silu(x)


def rope_inv_freq(head_dim: int, theta: float, scaling=None, device=None) -> torch.Tensor:
    """RoPE inverse frequencies (f32), with optional long-context scaling.

    `scaling` is None, ("linear", factor) (every frequency / factor), or
    ("llama3", factor, low_freq_factor, high_freq_factor, orig_max): the
    Llama-3.1 scheme, where wavelengths shorter than orig_max / high stay,
    those longer than orig_max / low divide by factor, and the band between
    blends by the smoothing ramp.
    """
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponent)
    if scaling is None:
        return inv_freq
    kind = scaling[0]
    if kind == "linear":
        return inv_freq / float(scaling[1])
    if kind == "llama3":
        factor, low_f, high_f, orig_max = (float(s) for s in scaling[1:5])
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        smooth = ((orig_max / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
        blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        out = torch.where(wavelen > low_wl, inv_freq / factor, blended)
        return torch.where(wavelen < high_wl, inv_freq, out)
    raise ValueError(f"unsupported rope scaling {scaling!r}")


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                     scaling=None):
    """RoPE cos/sin tables for positions (B, T) → two (B, T, head_dim // 2) f32."""
    inv_freq = rope_inv_freq(head_dim, theta, scaling, device=positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to (B, T, H, D) given (B, T, D/2) tables (rotate-half form)."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, Hkv, D)
    v: torch.Tensor,  # (B, Tk, Hkv, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Tq, Tk); True=keep
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,  # additive logits bias (ALiBi etc.)
) -> torch.Tensor:
    """Multi-head attention with f32 logits and softmax and GQA (KV heads
    repeated when Hkv != H); masked logits take the f32 minimum (not −inf),
    so a fully masked row stays finite."""
    H, D = q.shape[2:]
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = scale if scale is not None else 1.0 / (D**0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def make_causal_mask(Tq: int, Tk: int, offset: int = 0, device=None) -> torch.Tensor:
    """(1, 1, Tq, Tk) boolean causal mask; offset = #cached tokens before q."""
    qi = torch.arange(Tq, device=device)[:, None] + offset
    ki = torch.arange(Tk, device=device)[None, :]
    return (ki <= qi)[None, None, :, :]


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) int/bool → (B, 1, 1, Tk) boolean."""
    return attention_mask.to(torch.bool)[:, None, None, :]
