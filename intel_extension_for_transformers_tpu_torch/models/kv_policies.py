"""KV-cache compression policies: H2O heavy hitters and attention sinks.

Port of `intel_extension_for_transformers_tpu/models/kv_policies.py`:

- a **slot cache** (`SlotKVCache`): fixed (B, S, Hkv, D) buffers a layer
  plus each slot's absolute position (-1 = empty) and, for H2O, the
  attention mass each slot has received. Evicting a token means choosing a
  victim slot and writing the new token's K/V over it, so shapes never
  change. RoPE is applied before caching, so a slot needs no re-rotation;
  attention masks on "slot is filled".
- `H2OKVPolicy`: evict the non-recent slot with the least accumulated
  attention mass. `AttentionSinkKVPolicy` (StreamingLLM): keep the first
  `sink_size` positions, evict the oldest of the rest.

A policy plugs into `models.generation.generate_stream(kv_policy=...)`
through `init_cache` / `prefill` / `decode_step`. The prefill is the plain
`llama_apply` into the first T slots. A decode step runs the model's own
linear layers (`WOQLinear` in a quantized model: K1, K2 or K3 on the card,
at M = B) and attends over the slots in plain PyTorch, as the JAX package
computes it outside Pallas.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from intel_extension_for_transformers_tpu_torch.models.generation import (
    SamplingConfig,
    _mark_seen,
    sample_logits,
)
from intel_extension_for_transformers_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    _dense,
    llama_apply,
)
from intel_extension_for_transformers_tpu_torch.ops.layers import (
    apply_rotary,
    rms_norm,
    rotary_embedding,
    silu,
)

_INT32_MAX = 2**31 - 1


@dataclass
class SlotKVCache:
    """Fixed-slot cache: K/V a layer, slot positions and the H2O mass."""

    k: List[torch.Tensor]  # num_layers x (B, S, Hkv, D)
    v: List[torch.Tensor]
    positions: torch.Tensor  # (B, S) int64, -1 = empty
    accum: torch.Tensor  # (L, B, S) f32 accumulated attention mass
    next_pos: int  # the next absolute position


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) bool → (B,) the first True column of each row (S if none), as
    `jnp.argmax` / `jnp.argmin` return the first index among ties."""
    S = mask.shape[1]
    cols = torch.arange(S, device=mask.device).expand_as(mask)
    return torch.where(mask, cols, S).amin(dim=1)


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S) → (B,) the first column holding each row's minimum."""
    return _first_index(x == x.amin(dim=1, keepdim=True))


def _attend_slots(q, k_slots, v_slots, slot_valid):
    """q (B, T, H, D) over slot caches (B, S, Hkv, D) → (ctx (B, T, H, D),
    the attention mass each slot received (B, S), summed over heads and
    queries: the H2O statistic)."""
    B, T, H, D = q.shape
    Hkv = k_slots.shape[2]
    if Hkv != H:
        k_slots = k_slots.repeat_interleave(H // Hkv, dim=2)
        v_slots = v_slots.repeat_interleave(H // Hkv, dim=2)
    # the JAX package multiplies by the f32 constant 1 / sqrt(D) under jit
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_slots.float()) * (1.0 / (D**0.5))
    logits = logits.masked_fill(~slot_valid[:, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v_slots)
    return ctx, probs.sum(dim=(1, 2))


def _layer_decode(layer, x, config: LlamaConfig, cos, sin, ck, cv, slot_valid, victim):
    """One decoder layer over the slot cache; writes the new K/V at each
    row's `victim` slot (in place) → (x, attention mass (B, S))."""
    B, T, h = x.shape
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    att = layer.attention
    xn = rms_norm(x, layer.input_norm, config.rms_norm_eps)
    q = _dense(att.q, xn).reshape(B, T, nh, hd)
    k = _dense(att.k, xn).reshape(B, T, nkv, hd)
    v = _dense(att.v, xn).reshape(B, T, nkv, hd)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    # every row's victim is a slot inside the cache: nothing to drop
    rows = torch.arange(B, device=x.device)
    ck.index_put_((rows, victim), k[:, 0].to(ck.dtype))
    cv.index_put_((rows, victim), v[:, 0].to(cv.dtype))

    ctx, mass = _attend_slots(q, ck.to(x.dtype), cv.to(x.dtype), slot_valid)
    x = x + _dense(att.o, ctx.reshape(B, T, h))
    mlp = layer.mlp
    xn = rms_norm(x, layer.post_norm, config.rms_norm_eps)
    y = silu(_dense(mlp.gate, xn)) * _dense(mlp.up, xn)
    return x + _dense(mlp.down, y), mass


class _SlotPolicyBase:
    """Prefill and decode over a SlotKVCache; subclasses pick the victim."""

    budget: int

    def init_cache(self, config: LlamaConfig, batch: int, budget: int, dtype=torch.bfloat16,
                   device=None) -> SlotKVCache:
        budget = min(budget, self.budget)
        shape = (batch, budget, config.num_key_value_heads, config.head_dim)
        L = config.num_hidden_layers
        return SlotKVCache(
            k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
            v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
            positions=torch.full((batch, budget), -1, dtype=torch.int64, device=device),
            accum=torch.zeros((L, batch, budget), dtype=torch.float32, device=device),
            next_pos=0,
        )

    @torch.no_grad()
    def prefill(self, model, config: LlamaConfig, ids: torch.Tensor, cache: SlotKVCache):
        """The prompt pass, a plain forward into the first T slots. T must fit
        the budget: tokens are evicted only while decoding."""
        B, T = ids.shape
        S = cache.positions.shape[1]
        if T > S:
            raise ValueError(f"prompt length {T} exceeds KV budget {S}")
        # k[:, :T] are views: the plain forward writes the first T slots in place
        tmp = KVCache(k=[c[:, :T] for c in cache.k], v=[c[:, :T] for c in cache.v], length=0)
        logits, _ = llama_apply(model, config, ids, tmp)
        positions = cache.positions.clone()
        positions[:, :T] = torch.arange(T, device=positions.device)[None, :]
        return logits, SlotKVCache(k=cache.k, v=cache.v, positions=positions, accum=cache.accum, next_pos=T)

    def decode_step(self, model, config, cfg: SamplingConfig, cache, token, generator, seen):
        """Feed `token` (B,) → (next token (B,), cache, seen)."""
        logits, cache = _policy_forward(self, model, config, cache, token)
        nxt = sample_logits(logits[:, -1], generator, cfg, seen)
        return nxt, cache, _mark_seen(seen, nxt)

    def select_victim(self, cache: SlotKVCache) -> torch.Tensor:
        raise NotImplementedError


def victims(policy, cache: SlotKVCache) -> torch.Tensor:
    """(B,) the slot each row's next token takes: the first empty slot, else
    the policy's choice."""
    empty = cache.positions < 0
    return torch.where(empty.any(dim=1), _first_index(empty), policy.select_victim(cache))


@torch.no_grad()
def _policy_forward(policy, model, config: LlamaConfig, cache: SlotKVCache, token: torch.Tensor):
    """One decode forward of `token` (B,) over the slot cache → (logits
    (B, 1, V), the cache with the token in each row's victim slot)."""
    B = token.shape[0]
    dev = token.device
    victim = victims(policy, cache)
    rows = torch.arange(B, device=dev)
    positions = cache.positions.index_put((rows, victim), torch.full((B,), cache.next_pos, device=dev))
    slot_valid = positions >= 0
    pos = torch.full((B, 1), cache.next_pos, dtype=torch.int64, device=dev)
    cos, sin = rotary_embedding(pos, config.head_dim, config.rope_theta, config.rope_scaling)

    x = model.embed_tokens[token[:, None]]
    accum = cache.accum.clone()
    for li, layer in enumerate(model.layers):
        x, mass = _layer_decode(layer, x, config, cos, sin, cache.k[li], cache.v[li], slot_valid, victim)
        # the victim holds a new token: its statistic restarts, then this step's mass adds
        accum[li].index_put_((rows, victim), torch.zeros((B,), dtype=accum.dtype, device=dev))
        accum[li] += mass
    x = rms_norm(x, model.final_norm, config.rms_norm_eps)
    logits = _dense(model.lm_head, x)
    return logits, SlotKVCache(k=cache.k, v=cache.v, positions=positions, accum=accum,
                               next_pos=cache.next_pos + 1)


@dataclass(frozen=True)
class H2OKVPolicy(_SlotPolicyBase):
    """Evict the non-recent slot with the least accumulated attention."""

    budget: int = 512
    recent_size: int = 64

    def select_victim(self, cache: SlotKVCache) -> torch.Tensor:
        protected = cache.positions >= cache.next_pos - self.recent_size
        score = torch.where(protected, torch.inf, cache.accum.sum(dim=0))
        return _argmin_first(score)


@dataclass(frozen=True)
class AttentionSinkKVPolicy(_SlotPolicyBase):
    """StreamingLLM: keep the first `sink_size` positions and a recent ring;
    evict the oldest non-sink slot."""

    budget: int = 512
    sink_size: int = 4

    def select_victim(self, cache: SlotKVCache) -> torch.Tensor:
        pos = cache.positions
        age = torch.where((pos < self.sink_size) & (pos >= 0), _INT32_MAX, pos)
        return _argmin_first(torch.where(age < 0, _INT32_MAX, age))
