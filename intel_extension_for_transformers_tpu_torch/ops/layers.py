"""Shared NN building blocks in plain PyTorch.

Port of the part of `intel_extension_for_transformers_tpu/ops/layers.py`
the BERT encoder uses. No kernel sits here: the JAX package leaves these to
XLA fusion, and the port leaves them to PyTorch's own operators. The
linear-layer dispatch (`dense` on the weight's leaf type) becomes a module
swap: a quantized model holds `WOQLinear` where the float one holds
`nn.Linear` (`quantization.quantize_model`). RoPE, rms_norm, LoRA and W8A8
are not ported yet.
"""

from __future__ import annotations

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


def gelu(x, approximate: bool = True):
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, H, D)
    v: torch.Tensor,  # (B, Tk, H, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Tq, Tk); True=keep
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention with f32 logits and softmax; masked logits take
    the f32 minimum (not −inf), so a fully masked row stays finite."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) int/bool → (B, 1, 1, Tk) boolean."""
    return attention_mask.to(torch.bool)[:, None, None, :]
