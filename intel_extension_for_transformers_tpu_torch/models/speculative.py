"""Speculative decoding: a draft model proposes, the target verifies.

Port of `intel_extension_for_transformers_tpu/models/speculative.py`:

- each round the draft decodes `spec_k` tokens one at a time (M = 1 on the
  card: K1's split-K GEMV for an int4 draft) and the target scores all
  spec_k + 1 positions in one forward (M = spec_k + 1: K1's tensor-core
  tiles);
- acceptance is Leviathan / Chen speculative sampling: draft token d_i is
  kept with probability min(1, p_i / q_i); the first rejected position
  draws from max(p - q, 0), and a round that keeps every draft draws a
  bonus token from the target's last row. Greedy decoding keeps a draft
  token while it is the target's argmax, so its output equals target-only
  greedy decoding;
- a rejected draft costs no cache work: a cache's `length` is set back, and
  the rows past it are never attended (the causal mask is on absolute
  positions) until the next round writes over them.

`_accept` and `_next_token` take their random draws (the uniforms, the
Gumbel noise) as tensors, so a test can feed them the JAX package's draws;
`jax.random.categorical` is the argmax of logits plus Gumbel noise.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterator, Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.models.generation import SamplingConfig
from intel_extension_for_transformers_tpu_torch.models.llama import KVCache, LlamaConfig, init_kv_cache
from intel_extension_for_transformers_tpu_torch.models.registry import get_apply_fn


def _probs(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """softmax(logits / t) in f32, t >= 1e-4. The JAX package divides by the
    static t under jit, which XLA compiles as a product with the f32
    reciprocal; so does this."""
    t = max(temperature, 1e-4)
    inv = torch.full((), 1.0 / t, dtype=torch.float32, device=logits.device)
    return torch.softmax(logits.to(torch.float32) * inv, dim=-1)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(E) with E ~ Exp(1)."""
    e = torch.empty(shape, dtype=torch.float32, device=device).exponential_(generator=generator)
    return -torch.log(e)


def _categorical(dist: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """A draw from `dist` (..., V): argmax(log(dist + 1e-20) + Gumbel noise)."""
    return torch.argmax(torch.log(dist + 1e-20) + gumbel, dim=-1)


def _accept(p: torch.Tensor, qs: torch.Tensor, drafts: torch.Tensor, u: Optional[torch.Tensor],
            greedy: bool) -> torch.Tensor:
    """The number of leading draft tokens kept (a 0-d tensor, 0..K). p (K + 1,
    V) target, qs (K, V) draft probabilities, drafts (K,), u (K,) uniforms
    (unread when greedy)."""
    K = drafts.shape[0]
    if greedy:
        accept = drafts == torch.argmax(p[:K], dim=-1)
    else:
        p_d = p[:K].gather(1, drafts[:, None])[:, 0]
        q_d = qs.gather(1, drafts[:, None])[:, 0]
        accept = u < torch.clamp_max(p_d / q_d.clamp_min(1e-20), 1.0)
    return torch.cumprod(accept.to(torch.int64), dim=0).sum()


def _next_token(p: torch.Tensor, qs: torch.Tensor, n: torch.Tensor, gumbel: Optional[torch.Tensor],
                greedy: bool) -> torch.Tensor:
    """The token after the n kept drafts: the target's argmax at row n when
    greedy; else a draw (with `gumbel` (V,)) from the residual max(p - q, 0)
    at the first rejected row, or from the bonus row p[K] when all K were
    kept."""
    if greedy:
        return torch.argmax(p[n])
    K = qs.shape[0]
    i = torch.clamp_max(n, K - 1)
    resid = torch.clamp_min(p[i] - qs[i], 0.0)
    resid = resid / torch.clamp_min(resid.sum(), 1e-20)
    dist = torch.where(n == K, p[K], resid)
    return _categorical(dist, gumbel)


@torch.no_grad()
def _draft_propose(model, config, cache: KVCache, cur: torch.Tensor, generator, spec_k: int,
                   temperature: float, greedy: bool):
    """From token `cur` (1,) decode spec_k draft tokens → (tokens (K,), draft
    probabilities (K, V), the cache advanced K + 1: the last draft token is
    fed too, so both caches stay aligned and a round that keeps every draft
    needs no catch-up pass)."""
    apply = get_apply_fn(config)
    tok, toks, qs = cur, [], []
    for _ in range(spec_k):
        logits, cache = apply(model, config, tok[None, :], cache)
        q = _probs(logits[0, -1], temperature)
        if greedy:
            nxt = torch.argmax(q)
        else:
            nxt = _categorical(q, _gumbel(q.shape, generator, q.device))
        tok = nxt[None]
        toks.append(nxt)
        qs.append(q)
    _, cache = apply(model, config, tok[None, :], cache)
    return torch.stack(toks), torch.stack(qs), cache


@torch.no_grad()
def _verify(model, config, cache: KVCache, cur, drafts, qs, generator, spec_k: int, temperature: float,
            greedy: bool):
    """The target's forward over [cur, d_1..d_K] and the acceptance → (kept
    count (0-d), next token (0-d), the cache advanced K + 1)."""
    seq = torch.cat([cur, drafts])[None, :]
    logits, cache = get_apply_fn(config)(model, config, seq, cache)
    p = _probs(logits[0], temperature)  # (K + 1, V): row i is the distribution after token i
    u = gumbel = None
    if not greedy:
        u = torch.rand((spec_k,), generator=generator, device=p.device)
        gumbel = _gumbel(p.shape[1:], generator, p.device)
    n = _accept(p, qs, drafts, u, greedy)
    return n, _next_token(p, qs, n, gumbel, greedy), cache


def _rewind(t_cache: KVCache, d_cache: KVCache, length: int) -> tuple[KVCache, KVCache]:
    """Both caches back to `length` rows: the rest are never attended."""
    return replace(t_cache, length=length), replace(d_cache, length=length)


@torch.no_grad()
def generate_speculative_stream(
    target_model,
    target_config: LlamaConfig,
    draft_model,
    draft_config: LlamaConfig,
    input_ids,
    sampling: Optional[SamplingConfig] = None,
    *,
    spec_k: int = 4,
    max_cache_length: Optional[int] = None,
    cache_dtype=torch.bfloat16,
    seed: int = 0,
    stats: Optional[dict] = None,
) -> Iterator[np.ndarray]:
    """Yield the tokens of each round as one int32 array; distributed as
    target-only sampling (equal to it when greedy). Batch size 1. `stats`,
    if given, receives rounds, accepted and acceptance_rate."""
    cfg = sampling or SamplingConfig()
    dev = next(target_model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).to(torch.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    if ids.shape[0] != 1:
        raise ValueError("speculative decoding is a single-stream path (batch 1)")
    T = ids.shape[1]
    S = max_cache_length or (T + cfg.max_new_tokens + spec_k + 2)
    greedy = (not cfg.do_sample) or cfg.temperature <= 0
    temp = cfg.temperature if cfg.do_sample else 0.0
    generator = torch.Generator(device=dev).manual_seed(seed)

    t_cache = init_kv_cache(target_config, 1, S, dtype=cache_dtype, device=dev)
    d_cache = init_kv_cache(draft_config, 1, S, dtype=cache_dtype, device=dev)
    t_logits, t_cache = get_apply_fn(target_config)(target_model, target_config, ids, t_cache)
    _, d_cache = get_apply_fn(draft_config)(draft_model, draft_config, ids, d_cache)

    p0 = _probs(t_logits[0, -1], temp)
    if greedy:
        cur = torch.argmax(p0)[None]
    else:
        cur = _categorical(p0, _gumbel(p0.shape, generator, dev))[None]

    def report(rounds, accepted):
        if stats is not None:
            stats.update(rounds=rounds, accepted=accepted,
                         acceptance_rate=accepted / max(1, rounds * spec_k))

    # the caches hold the prompt; cur, the first generated token, is not cached yet
    eos = cfg.eos_token_id
    out_chunk = [int(cur[0])]
    produced, accepted_total, rounds = 1, 0, 0
    if eos is not None and out_chunk[0] == eos:
        report(rounds, accepted_total)
        yield np.asarray(out_chunk, np.int32)
        return

    while produced < cfg.max_new_tokens:
        base = int(t_cache.length)  # the context before this round
        drafts, qs, d_cache = _draft_propose(draft_model, draft_config, d_cache, cur, generator, spec_k,
                                             temp, greedy)
        n, nxt, t_cache = _verify(target_model, target_config, t_cache, cur, drafts, qs, generator,
                                  spec_k, temp, greedy)
        got = torch.cat([drafts, nxt[None]]).tolist()  # one readback a round
        n_i = int(n)
        rounds += 1
        accepted_total += n_i
        # both caches keep the prompt, cur and the n kept drafts
        t_cache, d_cache = _rewind(t_cache, d_cache, base + 1 + n_i)

        toks = got[:n_i] + [got[-1]]
        for t in toks:
            if produced >= cfg.max_new_tokens:
                break
            out_chunk.append(t)
            produced += 1
            if eos is not None and t == eos:
                report(rounds, accepted_total)
                yield np.asarray(out_chunk, np.int32)
                return
        cur = torch.tensor([toks[-1]], dtype=torch.int64, device=dev)
        yield np.asarray(out_chunk, np.int32)
        out_chunk = []

    if out_chunk:
        yield np.asarray(out_chunk, np.int32)
    report(rounds, accepted_total)


def generate_speculative(
    target_model,
    target_config: LlamaConfig,
    draft_model,
    draft_config: LlamaConfig,
    input_ids,
    sampling: Optional[SamplingConfig] = None,
    **kw,
) -> np.ndarray:
    """→ (1, <= max_new_tokens) generated ids."""
    chunks = list(generate_speculative_stream(
        target_model, target_config, draft_model, draft_config, input_ids, sampling, **kw))
    if not chunks:
        return np.zeros((1, 0), np.int32)
    return np.concatenate(chunks)[None, :]
