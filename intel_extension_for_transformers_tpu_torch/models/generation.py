"""Autoregressive generation: sampling, streaming, a fixed-length loop.

Port of `intel_extension_for_transformers_tpu/models/generation.py`:

- `generate_stream` / `generate`: prefill once into a preallocated KV cache,
  then one decode step per token; tokens are yielded as (B,) numpy arrays as
  they are sampled, the streaming surface the chat layer consumes.
- `generate_compiled`: the JAX package's one-program decode loop; here the
  same decode loop as the stream, collected into the (tokens, lengths)
  contract with the same EOS fill. A CUDA graph of it is later work.
- `sample_logits`: greedy, temperature, top-k, top-p and repetition penalty
  in f32. Draws come from an explicit `torch.Generator`, so sampled tokens
  differ from `jax.random`'s; greedy tokens and the filtered support match.
- `generate_stream(kv_policy=...)`: a bounded KV cache
  (`models/kv_policies.py`, H2O or attention sinks) takes the plain cache's
  place: the policy's `init_cache` / `prefill` / `decode_step`.
- `generate_beam`: beam search in the JAX package's alive/finished form, K
  beams decoded as one batch of K rows (K1's tensor-core tiles at M = K on
  the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.models.llama import KVCache, LlamaConfig, init_kv_cache
from intel_extension_for_transformers_tpu_torch.models.registry import get_apply_fn


@dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    repetition_penalty: float = 1.0
    eos_token_id: Optional[int] = None


def filter_logits(
    logits: torch.Tensor, cfg: SamplingConfig, seen_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, V) → f32 logits after repetition penalty, and, when sampling,
    temperature, top-k and top-p: tokens outside the support are -inf."""
    logits = logits.to(torch.float32)
    if cfg.repetition_penalty != 1.0 and seen_mask is not None:
        penalized = torch.where(
            logits > 0, logits / cfg.repetition_penalty, logits * cfg.repetition_penalty
        )
        logits = torch.where(seen_mask, penalized, logits)
    if not cfg.do_sample:
        return logits
    if cfg.temperature != 1.0:
        logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative probability >= top_p; keep at least one
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits


def sample_logits(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,
    cfg: SamplingConfig,
    seen_mask: Optional[torch.Tensor] = None,  # (B, V) bool: tokens already seen
) -> torch.Tensor:
    """→ (B,) int64 next token ids (argmax when not sampling)."""
    logits = filter_logits(logits, cfg, seen_mask)
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _seen_from_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    seen = torch.zeros((ids.shape[0], vocab), dtype=torch.bool, device=ids.device)
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    ok = ids < vocab  # out-of-vocabulary ids mark nothing, as a one-hot of them is empty
    seen[rows[ok], ids[ok]] = True
    return seen


def _mark_seen(seen: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    seen[torch.arange(seen.shape[0], device=seen.device), token] = True
    return seen


def _token_stream(model, config, input_ids, cfg, generator, max_cache_length, cache_dtype, kv_policy=None):
    """The decode loop: prefill into a preallocated KV cache (or the
    policy's bounded one), then one step per token, yielding (B,) ids until
    max_new_tokens or every row's EOS."""
    apply = get_apply_fn(config)
    dev = next(model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).to(torch.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    B, T = ids.shape
    S = max_cache_length or (T + cfg.max_new_tokens)
    if kv_policy is not None:
        cache = kv_policy.init_cache(config, B, S, dtype=cache_dtype, device=dev)
        logits, cache = kv_policy.prefill(model, config, ids, cache)
    else:
        cache = init_kv_cache(config, B, S, dtype=cache_dtype, device=dev)
        logits, cache = apply(model, config, ids, cache)
    seen = _seen_from_ids(ids, config.vocab_size)
    token = sample_logits(logits[:, -1], generator, cfg, seen)
    seen = _mark_seen(seen, token)

    eos = cfg.eos_token_id
    finished = np.zeros((B,), bool)
    for step in range(cfg.max_new_tokens):
        out = token.cpu().numpy()
        yield out
        if eos is not None:
            finished |= out == eos
            if finished.all():
                return
        if step + 1 == cfg.max_new_tokens:
            return  # the JAX loop's one extra decode step feeds no token
        if kv_policy is not None:
            token, cache, seen = kv_policy.decode_step(model, config, cfg, cache, token, generator, seen)
            continue
        logits, cache = apply(model, config, token[:, None], cache)
        token = sample_logits(logits[:, -1], generator, cfg, seen)
        seen = _mark_seen(seen, token)


def generate_stream(
    model,
    config: LlamaConfig,
    input_ids,  # (B, T) or (T,)
    sampling: Optional[SamplingConfig] = None,
    *,
    max_cache_length: Optional[int] = None,
    cache_dtype=torch.bfloat16,
    seed: int = 0,
    kv_policy=None,
) -> Iterator[np.ndarray]:
    """Yield (B,) token ids one decode step at a time. `kv_policy` (an
    `H2OKVPolicy` or `AttentionSinkKVPolicy`) bounds the cache to its budget."""
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    yield from _token_stream(
        model, config, input_ids, sampling or SamplingConfig(), generator,
        max_cache_length, cache_dtype, kv_policy,
    )


def generate(
    model,
    config: LlamaConfig,
    input_ids,
    sampling: Optional[SamplingConfig] = None,
    **kw,
) -> np.ndarray:
    """→ (B, <= max_new_tokens) generated ids (prompt excluded)."""
    toks = list(generate_stream(model, config, input_ids, sampling, **kw))
    if not toks:
        return np.zeros((0, 0), np.int32)
    return np.stack(toks, axis=1)


def generate_compiled(
    model,
    config: LlamaConfig,
    input_ids,  # (B, T)
    cfg: SamplingConfig,
    generator: torch.Generator,
    max_cache_length: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly max_new_tokens positions → (tokens (B, max_new_tokens),
    lengths (B,)). Positions after a row's EOS hold EOS."""
    dev = next(model.parameters()).device
    toks = np.stack(list(_token_stream(
        model, config, input_ids, cfg, generator, max_cache_length, torch.bfloat16,
    )), axis=1)
    B, n = toks.shape
    toks = torch.as_tensor(toks, dtype=torch.int64, device=dev)
    if cfg.eos_token_id is None:
        return toks, torch.full((B,), n, dtype=torch.int32, device=dev)
    eos = cfg.eos_token_id
    # the stream ends early only once every row has emitted EOS
    toks = torch.nn.functional.pad(toks, (0, cfg.max_new_tokens - n), value=eos)
    after = torch.cummax((toks == eos).to(torch.int32), dim=1).values.bool()
    toks = toks.masked_fill(after, eos)
    return toks, (~after).sum(dim=1, dtype=torch.int32)


def detokenize_stream(
    token_iter: Iterator[np.ndarray], tokenizer, skip_special_tokens: bool = True
) -> Iterator[str]:
    """Incremental detokenizer: yields printable text deltas.

    Only the tokens since the last emitted delta are decoded again, so a
    request costs O(n) in its length; trailing bytes of an incomplete
    character are held back."""
    acc: list[int] = []
    prefix_offset = 0  # start of the held-back decode window
    read_offset = 0  # end of the already-emitted part of the window
    for tok in token_iter:
        acc.append(int(tok[0]) if tok.ndim else int(tok))
        prefix_text = tokenizer.decode(
            acc[prefix_offset:read_offset], skip_special_tokens=skip_special_tokens
        )
        text = tokenizer.decode(acc[prefix_offset:], skip_special_tokens=skip_special_tokens)
        if text.endswith("�"):
            continue
        if len(text) > len(prefix_text):
            delta = text[len(prefix_text):]
            prefix_offset = read_offset
            read_offset = len(acc)
            yield delta


# ------------------------------ beam search ------------------------------

_NEG = -1e9  # the score of an empty beam or finished slot


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a 1-D tensor, best first, the lowest index first among
    ties, as `lax.top_k` orders them (the finished pool is mostly tied
    -1e9 entries, so `torch.topk`'s order among ties would pick other rows)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _reorder_cache(cache: KVCache, parents: torch.Tensor) -> KVCache:
    """Each beam's row of every per-slot buffer (K/V and, in an int8 cache,
    their scales) taken from its parent's row."""

    def take(bufs):
        return None if bufs is None else [b.index_select(0, parents) for b in bufs]

    return KVCache(k=take(cache.k), v=take(cache.v), length=cache.length,
                   k_scale=take(cache.k_scale), v_scale=take(cache.v_scale))


@torch.no_grad()
def _beam_search_loop(model, config, prompt, *, num_beams, max_new_tokens, length_penalty, eos_token_id,
                      cache_dtype=torch.bfloat16):
    """Beam search over the prompt (1, T) → (best_ids (max_new,), best_score,
    best_len), in the JAX package's alive/finished form: each step ranks 2K
    candidates, so K stay alive even when K of them end in EOS; a finished
    beam scores its summed log-probabilities / len ** length_penalty; the
    result is the best finished beam if it beats the best alive one after
    the same penalty. The K beams decode as one batch of K rows. The JAX
    loop's forward after the last token feeds nothing and is skipped."""
    apply = get_apply_fn(config)
    dev = prompt.device
    K, T, V = num_beams, prompt.shape[1], config.vocab_size
    f32 = torch.float32
    cache = init_kv_cache(config, K, T + max_new_tokens, dtype=cache_dtype, device=dev)
    logits, cache = apply(model, config, prompt.expand(K, T), cache)
    last_logits = logits[:, -1]

    alive_scores = torch.full((K,), _NEG, dtype=f32, device=dev)
    alive_scores[0] = 0.0
    alive_seqs = torch.zeros((K, max_new_tokens), dtype=torch.int64, device=dev)
    fin_seqs = torch.zeros((K, max_new_tokens), dtype=torch.int64, device=dev)
    fin_scores = torch.full((K,), _NEG, dtype=f32, device=dev)
    fin_lens = torch.zeros((K,), dtype=torch.int64, device=dev)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    lp = torch.tensor(float(length_penalty), dtype=f32, device=dev)

    for i in range(max_new_tokens):
        logp = torch.log_softmax(last_logits.to(f32), dim=-1)  # (K, V)
        top_scores, top_flat = _top_k_stable((alive_scores[:, None] + logp).reshape(-1), 2 * K)
        parents = top_flat // V
        tokens = top_flat % V
        cand_seqs = alive_seqs.index_select(0, parents)
        cand_seqs[:, i] = tokens
        is_eos = tokens == eos

        # the finished pool: the K held and this step's EOS candidates, best K kept;
        # the JAX penalty (i + 1) ** lp is traced, so this divides truly
        penal = torch.tensor(float(i + 1), dtype=f32, device=dev) ** lp
        cand_fin = torch.where(is_eos, top_scores / penal, torch.full_like(top_scores, _NEG))
        fin_top, fin_idx = _top_k_stable(torch.cat([fin_scores, cand_fin]), K)
        fin_seqs = torch.cat([fin_seqs, cand_seqs]).index_select(0, fin_idx)
        fin_lens = torch.cat([fin_lens, torch.full((2 * K,), i + 1, dtype=torch.int64, device=dev)])[fin_idx]
        fin_scores = fin_top

        # the alive pool: the best K candidates that did not end in EOS
        a_top, a_idx = _top_k_stable(torch.where(is_eos, torch.full_like(top_scores, _NEG), top_scores), K)
        alive_scores = a_top
        alive_seqs = cand_seqs.index_select(0, a_idx)
        if i + 1 < max_new_tokens:
            cache = _reorder_cache(cache, parents.index_select(0, a_idx))
            logits, cache = apply(model, config, tokens.index_select(0, a_idx)[:, None], cache)
            last_logits = logits[:, -1]

    # the JAX penalty of max_new_tokens is a constant under jit, and XLA
    # divides by a constant as a product with its f32 reciprocal
    penal = torch.tensor(float(max(max_new_tokens, 1)), dtype=f32, device=dev) ** lp
    alive_final = alive_scores * (1.0 / penal)
    best_alive = int(torch.argmax(alive_final))
    use_fin = bool(fin_scores[0] > _NEG / 2) and bool(fin_scores[0] >= alive_final[best_alive])
    if use_fin:
        return fin_seqs[0], fin_scores[0], int(fin_lens[0])
    return alive_seqs[best_alive], alive_final[best_alive], max_new_tokens


def generate_beam(
    model,
    config: LlamaConfig,
    input_ids,  # (T,) or (1, T)
    *,
    num_beams: int = 4,
    max_new_tokens: int = 32,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
    cache_dtype=torch.bfloat16,
) -> tuple[np.ndarray, float]:
    """Beam-search decode → (generated ids, the final EOS included if one was
    hit, and the sequence score)."""
    dev = next(model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).to(torch.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    best_ids, best_score, n = _beam_search_loop(
        model, config, ids, num_beams=num_beams, max_new_tokens=max_new_tokens,
        length_penalty=float(length_penalty), eos_token_id=eos_token_id, cache_dtype=cache_dtype,
    )
    return best_ids[:n].cpu().numpy().astype(np.int32), float(best_score)
