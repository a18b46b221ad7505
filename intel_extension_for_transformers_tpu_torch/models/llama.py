"""Llama-family decoder (RMSNorm, RoPE, GQA, SwiGLU) as `nn.Module`s.

Port of `intel_extension_for_transformers_tpu/models/llama.py`. The module
tree mirrors the JAX params tree (embed_tokens / layers[i] / attention / q
..., lm_head), so a layer's path is the same in both packages
("layers/0/attention/q/kernel") and `quantization.quantize_model` picks the
same layers. Float linear layers are `nn.Linear` (weight stored (out, in),
the transpose of the JAX `kernel`); after quantization they are
`WOQLinear`, whose int4 products run K1 (khalf) or K3 (w32).

- **KV cache**: preallocated (B, S_max, Hkv, D) buffers per layer and a
  fill `length` (an int, or a (B,) tensor of per-row lengths). The port
  writes new rows into the buffers in place, where the JAX package returns
  new arrays; the returned `KVCache` shares the buffers with its new length.
- **Attention routing** follows the JAX package: a forward with a cache, a
  mask or a sliding window runs `ops.layers.attention` over masked logits; a
  no-cache, unmasked, global forward of T >= 1024 runs
  `ops.flash_attention.flash_attention` (K4 on the card). The JAX package's
  ITX_DISABLE_FLASH switch is not read; an all-ones `attention_mask` sends a
  forward to the plain path.

Not ported yet: the Mixtral MoE MLP, ring attention, remat,
`llama_apply_with_hidden` and the HF config conversion.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.ops.flash_attention import flash_attention
from intel_extension_for_transformers_tpu_torch.ops.layers import (
    apply_rotary,
    attention,
    rms_norm,
    rotary_embedding,
    silu,
)

FLASH_MIN_T = 1024


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    # None, ("linear", factor), or ("llama3", factor, low_f, high_f, orig_max)
    rope_scaling: Optional[tuple] = None
    # Mistral-style sliding window: keys older than `window` positions are
    # masked out (None = global attention)
    sliding_window: Optional[int] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # Mixture-of-Experts (Mixtral family): 0 = dense MLP
    num_local_experts: int = 0
    num_experts_per_tok: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        base = dict(
            vocab_size=512,
            hidden_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            intermediate_size=256,
            max_position_embeddings=256,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama2_7b(cls):
        return cls()

    @classmethod
    def mixtral_8x7b(cls):
        """The Mixtral config; building its model raises until the MoE MLP is ported."""
        return cls(
            num_key_value_heads=8,
            intermediate_size=14336,
            max_position_embeddings=32768,
            rope_theta=1e6,
            num_local_experts=8,
            num_experts_per_tok=2,
        )

    @classmethod
    def llama3_8b(cls):
        return cls(
            vocab_size=128256,
            num_key_value_heads=8,
            intermediate_size=14336,
            rope_theta=500000.0,
            max_position_embeddings=8192,
        )

    @classmethod
    def llama31_8b(cls):
        """Llama-3.1: 128k context via the llama3 RoPE scaling scheme."""
        return cls(
            vocab_size=128256,
            num_key_value_heads=8,
            intermediate_size=14336,
            rope_theta=500000.0,
            max_position_embeddings=131072,
            rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0),
        )


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        h = config.hidden_size
        kvh = config.num_key_value_heads * config.head_dim
        self.q = nn.Linear(h, h, bias=False)
        self.k = nn.Linear(h, kvh, bias=False)
        self.v = nn.Linear(h, kvh, bias=False)
        self.o = nn.Linear(h, h, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate = nn.Linear(h, i, bias=False)
        self.up = nn.Linear(h, i, bias=False)
        self.down = nn.Linear(i, h, bias=False)


class LlamaLayer(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        h = config.hidden_size
        self.input_norm = nn.Parameter(torch.ones(h))
        self.attention = LlamaAttention(config)
        self.post_norm = nn.Parameter(torch.ones(h))
        self.mlp = LlamaMLP(config)


class LlamaModel(nn.Module):
    """Decoder parameters; the forward is `llama_apply`."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        if config.num_local_experts > 0:
            raise NotImplementedError(
                "the Mixtral MoE MLP is not ported yet (ROADMAP queue 1, step 10)"
            )
        self.config = config
        self.embed_tokens = nn.Parameter(torch.empty(config.vocab_size, config.hidden_size))
        self.layers = nn.ModuleList(LlamaLayer(config) for _ in range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size))
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def forward(self, input_ids, cache=None, attention_mask=None):
        return llama_apply(self, self.config, input_ids, cache, attention_mask)


@torch.no_grad()
def llama_init_params(
    generator: torch.Generator, config: LlamaConfig, dtype: torch.dtype = torch.float32
) -> LlamaModel:
    """Random init with the JAX init's shapes and scales: N(0, 0.02) embedding
    and kernels, unit norm scales. Draws come from `generator` on its device,
    where the model is built in `dtype`; the values differ from `jax.random`'s
    for any seed."""
    with torch.device("meta"):
        model = LlamaModel(config)
    model.to(dtype)  # on the meta device: no float32 copy is ever allocated
    model.to_empty(device=generator.device)
    for name, p in model.named_parameters():
        if name.endswith("_norm"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model.eval()


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """Per-layer KV buffers and the fill length.

    With k_scale / v_scale set (`init_kv_cache(dtype="int8")`) the buffers
    hold per-vector symmetric int8 with one f32 scale per (B, S, Hkv),
    quantized once at write and dequantized when attended."""

    k: List[torch.Tensor]  # num_layers x (B, S, Hkv, D)
    v: List[torch.Tensor]
    length: Union[int, torch.Tensor]  # int, or (B,) int64 per-row lengths
    k_scale: Optional[List[torch.Tensor]] = None  # int8 mode: num_layers x (B, S, Hkv)
    v_scale: Optional[List[torch.Tensor]] = None

    @property
    def max_length(self) -> int:
        return self.k[0].shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(
    config: LlamaConfig, batch: int, max_length: int, dtype=torch.bfloat16, device=None
) -> KVCache:
    shape = (batch, max_length, config.num_key_value_heads, config.head_dim)
    L = config.num_hidden_layers

    def zeros(shape, dt):
        return [torch.zeros(shape, dtype=dt, device=device) for _ in range(L)]

    if dtype in ("int8", torch.int8):
        return KVCache(
            k=zeros(shape, torch.int8), v=zeros(shape, torch.int8), length=0,
            k_scale=zeros(shape[:-1], torch.float32), v_scale=zeros(shape[:-1], torch.float32),
        )
    return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype), length=0)


def _kv_quantize(t: torch.Tensor):
    """(B, T, H, D) float → (int8 codes, (B, T, H) f32 scales).

    / 127 is a product with the f32 reciprocal, as XLA compiles the JAX
    package's division by a constant; the codes then match bit for bit."""
    tf = t.to(torch.float32)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=t.device)
    sc = tf.abs().amax(dim=-1) * inv127
    q = torch.round(tf / sc[..., None].clamp_min(1e-8))
    return q.clamp(-127, 127).to(torch.int8), sc


def _cache_write(buf: torch.Tensor, new: torch.Tensor, start) -> torch.Tensor:
    """Write `new` (B, T, ...) into `buf` (B, S, ...) at rows [start, start + T),
    in place. `start` is an int (every row at one offset: prefill, batched
    generate) or a (B,) tensor of per-row offsets (a pool of slots with
    different fill lengths decoding in one batched step)."""
    new = new.to(buf.dtype)
    T = new.shape[1]
    if isinstance(start, int) or start.ndim == 0:
        s = int(start)
        buf[:, s : s + T] = new
    else:
        B = new.shape[0]
        rows = start.to(torch.int64)[:, None] + torch.arange(T, device=buf.device)[None, :]
        buf[torch.arange(B, device=buf.device)[:, None], rows] = new
    return buf


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A linear layer on x; a float weight is cast to x's dtype, as the JAX
    package's `dense` casts its kernel."""
    if isinstance(layer, nn.Linear) and layer.weight.dtype != x.dtype:
        bias = None if layer.bias is None else layer.bias.to(x.dtype)
        return nn.functional.linear(x, layer.weight.to(x.dtype), bias)
    return layer(x)


def _decoder_layer(layer: LlamaLayer, x, config: LlamaConfig, cos, sin, mask, cache_k,
                   cache_v, start, use_flash: bool = False, cache_ks=None, cache_vs=None):
    B, T, h = x.shape
    nh = config.num_attention_heads
    nkv = config.num_key_value_heads
    hd = config.head_dim

    att = layer.attention
    xn = rms_norm(x, layer.input_norm, config.rms_norm_eps)
    q = _dense(att.q, xn).reshape(B, T, nh, hd)
    k = _dense(att.k, xn).reshape(B, T, nkv, hd)
    v = _dense(att.v, xn).reshape(B, T, nkv, hd)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    if cache_k is not None and cache_ks is not None:
        # int8 KV: quantize the new rows once at write; dequantize to attend
        k8, ksc = _kv_quantize(k)
        v8, vsc = _kv_quantize(v)
        _cache_write(cache_k, k8, start)
        _cache_write(cache_v, v8, start)
        _cache_write(cache_ks, ksc, start)
        _cache_write(cache_vs, vsc, start)
        k_all = (cache_k.to(torch.float32) * cache_ks[..., None]).to(x.dtype)
        v_all = (cache_v.to(torch.float32) * cache_vs[..., None]).to(x.dtype)
    elif cache_k is not None:
        # write the new K/V at [start, start + T); attend over the whole buffer
        _cache_write(cache_k, k, start)
        _cache_write(cache_v, v, start)
        k_all, v_all = cache_k.to(x.dtype), cache_v.to(x.dtype)
    else:
        k_all, v_all = k, v

    if use_flash:
        ctx = flash_attention(q, k_all, v_all, causal=True).reshape(B, T, h)
    else:
        ctx = attention(q, k_all, v_all, mask=mask).reshape(B, T, h)
    x = x + _dense(att.o, ctx)

    mlp = layer.mlp
    xn = rms_norm(x, layer.post_norm, config.rms_norm_eps)
    y = silu(_dense(mlp.gate, xn)) * _dense(mlp.up, xn)
    return x + _dense(mlp.down, y)


@torch.no_grad()
def llama_apply(
    model: LlamaModel,
    config: LlamaConfig,
    input_ids: torch.Tensor,  # (B, T)
    cache: Optional[KVCache] = None,
    attention_mask: Optional[torch.Tensor] = None,  # (B, S_total) 1 = valid
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Forward → (logits (B, T, V), updated cache).

    Without a cache: a causal forward (scoring). With a cache: writes K/V at
    [cache.length, cache.length + T) and attends over the whole buffer with
    position masks, the same code for prefill (T = prompt) and decode (T = 1).
    """
    dev = model.embed_tokens.device
    input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
    B, T = input_ids.shape
    x = model.embed_tokens[input_ids]

    start = cache.length if cache is not None else 0
    steps = torch.arange(T, device=dev)
    if isinstance(start, torch.Tensor) and start.ndim:  # (B,) per-row fill lengths
        positions = start.to(torch.int64)[:, None] + steps[None, :]
    else:
        positions = (int(start) + steps)[None, :].expand(B, T)
    cos, sin = rotary_embedding(positions, config.head_dim, config.rope_theta, config.rope_scaling)

    use_flash = (
        cache is None
        and attention_mask is None
        and config.sliding_window is None
        and T >= FLASH_MIN_T
    )
    mask = None
    if cache is not None:
        S = cache.max_length
        ki = torch.arange(S, device=dev)[None, None, :]
        qi = positions[:, :, None]  # (B, T, 1)
        mask = ki <= qi  # (B, T, S) causal over absolute positions
        if config.sliding_window is not None:
            mask = mask & (qi - ki < config.sliding_window)
        mask = mask[:, None]  # (B, 1, T, S)
        if attention_mask is not None:
            mask = mask & attention_mask.to(dev).bool()[:, None, None, :S]
    elif not use_flash:
        qi = steps[:, None]
        ki = steps[None, :]
        causal = ki <= qi
        if config.sliding_window is not None:
            causal = causal & (qi - ki < config.sliding_window)
        mask = causal[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.to(dev).bool()[:, None, None, :T]

    quant = cache is not None and cache.quantized
    for li, layer in enumerate(model.layers):
        x = _decoder_layer(
            layer, x, config, cos, sin, mask,
            cache.k[li] if cache is not None else None,
            cache.v[li] if cache is not None else None,
            start, use_flash,
            cache.k_scale[li] if quant else None,
            cache.v_scale[li] if quant else None,
        )

    x = rms_norm(x, model.final_norm, config.rms_norm_eps)
    logits = _dense(model.lm_head, x)

    new_cache = None
    if cache is not None:
        new_cache = KVCache(
            k=cache.k, v=cache.v, length=cache.length + T,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
        )
    return logits, new_cache
