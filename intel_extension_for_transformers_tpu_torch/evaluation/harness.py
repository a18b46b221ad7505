"""LM evaluation harness core: log-likelihood scoring and perplexity.

Port of `intel_extension_for_transformers_tpu/evaluation/harness.py`:

- `loglikelihood(context, continuation)` → (sum log p(continuation |
  context), is_greedy), the primitive of multiple-choice tasks;
- `evaluate_perplexity(token_stream)`: rolling-window token perplexity.

Requests are padded into (B, T) batches with a continuation mask
(`_pad_batch`) and scored by one no-cache forward each; at T >= 1024 that
forward runs every layer's attention through flash attention (K4 on the
card). The task loaders (`evaluation/tasks.py`) are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch


@torch.no_grad()
def _score_batch(model, config, ids: torch.Tensor, cont_mask: torch.Tensor):
    """ids (B, T) int; cont_mask (B, T) 1 where the token belongs to the
    continuation (scored). → (sum ll (B,), greedy_match (B,))."""
    from intel_extension_for_transformers_tpu_torch.models.registry import get_apply_fn

    logits, _ = get_apply_fn(config)(model, config, ids)
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = ids[:, 1:].to(lp.device, torch.int64)
    tok_ll = torch.gather(lp, -1, tgt[..., None])[..., 0]
    m = cont_mask[:, 1:].to(lp.device, torch.float32)
    ll = (tok_ll * m).sum(dim=-1)
    greedy = torch.where(m > 0, lp.argmax(dim=-1) == tgt, True).all(dim=-1)
    return ll, greedy


def _pad_batch(
    reqs: Sequence[Tuple[List[int], List[int]]], pad_id: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    T = max(len(c) + len(k) for c, k in reqs)
    T = max(T, 2)
    ids = np.full((len(reqs), T), pad_id, np.int32)
    mask = np.zeros((len(reqs), T), np.int32)
    for i, (ctx, cont) in enumerate(reqs):
        seq = list(ctx) + list(cont)
        ids[i, : len(seq)] = seq
        mask[i, len(ctx) : len(seq)] = 1
    return ids, mask


def loglikelihood(
    model,
    config,
    requests: Sequence[Tuple[List[int], List[int]]],
    batch_size: int = 8,
) -> List[Tuple[float, bool]]:
    """requests: [(context_ids, continuation_ids)] → [(ll, is_greedy)]."""
    dev = next(model.parameters()).device
    out: List[Tuple[float, bool]] = []
    for i in range(0, len(requests), batch_size):
        ids, mask = _pad_batch(requests[i : i + batch_size])
        ll, greedy = _score_batch(
            model, config, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
        )
        out.extend(zip(ll.cpu().tolist(), greedy.cpu().tolist()))
    return out


def evaluate_multiple_choice(
    model,
    config,
    questions: Iterable[dict],
    batch_size: int = 8,
    length_normalize: bool = True,
) -> dict:
    """questions: [{"context": [ids], "choices": [[ids], ...], "gold": int}]
    → {"accuracy", "n"}. The choice is the argmax of the (normalized) ll."""
    questions = list(questions)
    reqs, spans = [], []
    for q in questions:
        spans.append((len(reqs), len(q["choices"])))
        for ch in q["choices"]:
            reqs.append((q["context"], ch))
    scored = loglikelihood(model, config, reqs, batch_size)
    correct = 0
    for q, (start, n) in zip(questions, spans):
        lls = []
        for j in range(n):
            ll, _ = scored[start + j]
            denom = max(len(q["choices"][j]), 1) if length_normalize else 1
            lls.append(ll / denom)
        if int(np.argmax(lls)) == q["gold"]:
            correct += 1
    return {"accuracy": correct / max(len(questions), 1), "n": len(questions)}


def evaluate_perplexity(
    model,
    config,
    token_ids: Sequence[int],
    window: int = 512,
    stride: int = 512,
    batch_size: int = 8,
) -> dict:
    """Rolling-window perplexity over a token stream."""
    ids = list(token_ids)
    reqs = []
    for s in range(0, max(len(ids) - 1, 1), stride):
        seg = ids[s : s + window]
        if len(seg) < 2:
            break
        reqs.append((seg[:1], seg[1:]))
    scored = loglikelihood(model, config, reqs, batch_size)
    total_ll = sum(ll for ll, _ in scored)
    total_tokens = sum(len(c) for _, c in reqs)
    nll = -total_ll / max(total_tokens, 1)
    return {
        "perplexity": float(np.exp(min(nll, 30.0))),
        "nll": float(nll),
        "tokens": total_tokens,
    }
