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

Beam search and the KV policies (sink / H2O) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, init_kv_cache
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


def _token_stream(model, config, input_ids, cfg, generator, max_cache_length, cache_dtype):
    """The decode loop: prefill into a preallocated KV cache, then one step
    per token, yielding (B,) ids until max_new_tokens or every row's EOS."""
    apply = get_apply_fn(config)
    dev = next(model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).to(torch.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    B, T = ids.shape
    S = max_cache_length or (T + cfg.max_new_tokens)
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
) -> Iterator[np.ndarray]:
    """Yield (B,) token ids one decode step at a time."""
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    yield from _token_stream(
        model, config, input_ids, sampling or SamplingConfig(), generator,
        max_cache_length, cache_dtype,
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
