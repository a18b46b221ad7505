"""Continuous-batching decode engine: slot-based join/leave generation.

Port of `intel_extension_for_transformers_tpu/models/engine.py`. The steps
are plain functions on tensors (no jit, no donation), the engine class and
its host loop are the same:

- A fixed pool of B decode *slots* shares ONE batched forward a step: the
  pool cache is one `KVCache` with (B, S, Hkv, D) buffers and a (B,) length,
  so every slot has its own position stream and the WOQ linears see M = B
  rows (K1's or K2's tensor-core tiles at B > 1 on the card, K3 by its
  route), streaming the weights once a step for every slot.
- Requests JOIN via **chunked prefill** into a single-slot cache (an int
  length), one (1, C) chunk a loop iteration for each of up to
  `max_admissions` admissions, issued after the pool step; a finished
  admission's cache is copied into its pool row (`_insert_slot`).
- Slots LEAVE on EOS / max_new_tokens / a complete guided choice / cancel;
  inactive slots still step (their rows are dead, rewritten on admission).
- Per-slot sampling knobs are tensors; draws come from one
  `torch.Generator` on the engine's device (Gumbel-max over the filtered
  logits, so nothing waits for the host), so sampled tokens differ from
  `jax.random`'s while greedy tokens and the filtered support match.
- **KV eviction policies** (`kv_policy="sink"|"h2o"`) compact a slot's cache
  in place when its next step would overflow: kept keys re-rotate by their
  position delta in f32 (int8 keys dequantize, rotate, requantize); H2O
  reads the per-key attention mass of `ops.layers`' tap.
- **Decode horizon** (`decode_horizon=H`): H pool steps queued back to back
  with no host sync inside, then one copy of the (H, B) token block.
- **In-pool speculation**: a draft model proposes gamma tokens a slot
  (gamma + 1 greedy steps), the target verifies them in one (B, gamma + 1)
  forward, and the lengths roll back to each slot's accepted count.
- **Prefix cache**: a finished admission's prompt cache is kept (LRU); a
  later prompt sharing its prefix restores a COPY of those rows (the port
  writes caches in place, where the JAX package's arrays are immutable and
  shared) and prefills only the tail.

The host loop runs in one background thread on that thread's current
stream; callers get a thread-safe iterator of tokens. Pipeline-parallel
serving (`pp_state`, the JAX package's `parallel/pp_serve.py`) is not
ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Iterator, Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.models.llama import KVCache, init_kv_cache
from intel_extension_for_transformers_tpu_torch.models.registry import get_apply_fn
from intel_extension_for_transformers_tpu_torch.ops.layers import rope_inv_freq, set_mass_tap
from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_KV_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32, "int8": "int8",
    torch.bfloat16: torch.bfloat16, torch.float16: torch.float16, torch.float32: torch.float32,
    torch.int8: "int8",
}


# --------------------------- batched sampling ---------------------------


def filter_logits_per_slot(logits, temperature, top_k, top_p, rep_penalty, seen, allow=None):
    """→ (greedy (B,), filtered (B, V)): the argmax after the guide mask and
    the repetition penalty, and the scaled logits outside each row's top-k /
    top-p support set to -inf (what the JAX sampler hands to
    `jax.random.categorical`)."""
    logits = logits.to(torch.float32)
    if allow is not None:
        logits = logits.masked_fill(~allow, -torch.inf)
    rp = rep_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen & (rp != 1.0), penalized, logits)
    greedy = torch.argmax(logits, dim=-1)

    scaled = logits / temperature[:, None].clamp_min(1e-6)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    V = logits.shape[-1]
    # top-k: threshold at the k-th largest (k = 0: no threshold)
    kth = sorted_desc.gather(1, (top_k - 1).clamp(0, V - 1)[:, None])
    thresh_k = torch.where(top_k[:, None] > 0, kth, -torch.inf)
    # top-p: the smallest prefix of sorted probabilities with cumsum >= p (>= 1 kept)
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1, keepdim=True)
    cutoff = sorted_desc.gather(1, cutoff_idx.clamp_max(V - 1))
    thresh_p = torch.where(top_p[:, None] < 1.0, cutoff, -torch.inf)
    filtered = torch.where(scaled < torch.maximum(thresh_k, thresh_p), -torch.inf, scaled)
    return greedy, filtered


def sample_logits_per_slot(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,
    temperature: torch.Tensor,  # (B,) f32
    top_k: torch.Tensor,  # (B,) int64, 0 = off
    top_p: torch.Tensor,  # (B,) f32 in (0, 1], 1 = off
    do_sample: torch.Tensor,  # (B,) bool
    rep_penalty: torch.Tensor,  # (B,) f32, 1 = off
    seen: torch.Tensor,  # (B, V) bool
    allow: Optional[torch.Tensor] = None,  # (B, V) bool: the guided-decoding mask
) -> torch.Tensor:
    """Vectorized per-slot sampler (each row its own knobs) → (B,) int64.
    A draw is the Gumbel-max of the filtered logits, as
    `jax.random.categorical` draws, from `generator`: no host sync."""
    greedy, filtered = filter_logits_per_slot(logits, temperature, top_k, top_p, rep_penalty, seen, allow)
    u = torch.rand(filtered.shape, generator=generator, device=filtered.device)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(filtered + gumbel, dim=-1)
    return torch.where(do_sample, sampled, greedy)


def _mark_seen(seen: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """seen (B, V) |= one_hot(tok (B,)), in place."""
    return seen.scatter_(1, tok[:, None], True)


# --------------------------- guided-choice state ---------------------------


@dataclass
class GuideState:
    """Device-resident constrained-decoding state (one row per slot): every
    allowed token sequence padded with -1, which of them still match the
    emitted prefix, the shared depth, and whether the slot is guided. The
    allow mask is a function of this state, derived inside the step."""

    seqs: torch.Tensor  # (B, S, L) int64, -1 = pad
    active: torch.Tensor  # (B, S) bool
    pos: torch.Tensor  # (B,) int64
    on: torch.Tensor  # (B,) bool


def _guide_current(g: GuideState):
    """Expected next token per (slot, seq) and its validity mask."""
    B, S, L = g.seqs.shape
    p = g.pos.clamp(0, L - 1)
    cur = g.seqs.gather(2, p[:, None, None].expand(B, S, 1))[..., 0]  # (B, S)
    valid = g.active & (cur >= 0) & (g.pos < L)[:, None]
    return cur, valid


def _guide_allow(g: GuideState, V: int):
    """(B, V) allow mask and (B,) constrained flag. A degenerate guide (no
    sequence matches) unconstrains rather than stalls. The JAX package's
    `.at[].max` scatter (duplicate tokens OR together, ids past V dropped)
    is a count by `scatter_add_` here, then > 0: the same mask."""
    cur, valid = _guide_current(g)
    inb = cur < V
    idx = torch.where(inb, cur.clamp_min(0), 0)
    allow = torch.zeros((cur.shape[0], V), dtype=torch.int32, device=cur.device)
    allow.scatter_add_(1, idx, (valid & inb).to(torch.int32))
    constrained = g.on & valid.any(dim=1)
    return torch.where(constrained[:, None], allow > 0, True), constrained


def _guide_advance(g: GuideState, nxt: torch.Tensor, constrained: torch.Tensor) -> GuideState:
    cur, valid = _guide_current(g)
    hit = valid & (cur == nxt[:, None])
    active = torch.where(constrained[:, None], hit, g.active)
    return replace(g, active=active, pos=g.pos + constrained.to(g.pos.dtype))


# ----------------------------- the steps -----------------------------


def _apply_tapped(apply_fn, model, config, ids, cache, with_mass: bool):
    """apply_fn, and with_mass: the sum over layers of the attention mass
    (B, T, S) that `ops.layers.attention` taps (else None)."""
    if not with_mass:
        logits, cache = apply_fn(model, config, ids, cache)
        return logits, cache, None
    tap = []
    set_mass_tap(tap)
    try:
        logits, cache = apply_fn(model, config, ids, cache)
    finally:
        set_mass_tap(None)
    return logits, cache, sum(tap)


def _step_body(
    model, config, cache, tokens, generator,
    temperature, top_k, top_p, do_sample, rep_penalty, seen, guide, accum,
    with_mass: bool = False,
):
    """One decode step for all slots: ONE batched apply (per-row cache
    lengths), so the WOQ products see M = B, and per-slot sampling. The
    cache, `seen` and `accum` are updated in place (the JAX package donates
    them). → (next tokens (B,), cache, seen, guide, accum)."""
    apply_fn = get_apply_fn(config)
    logits, cache, mass = _apply_tapped(apply_fn, model, config, tokens[:, None], cache, with_mass)
    if mass is not None:
        accum.add_(mass[:, 0])  # Σ layers of (B, 1, S) → (B, S)
    logits = logits[:, -1]  # (B, V)
    allow, constrained = _guide_allow(guide, logits.shape[-1])
    nxt = sample_logits_per_slot(
        logits, generator, temperature, top_k, top_p, do_sample, rep_penalty, seen, allow,
    )
    guide = _guide_advance(guide, nxt, constrained)
    _mark_seen(seen, nxt)
    return nxt, cache, seen, guide, accum


def _engine_step_multi(
    model, config, cache, tokens, generator,
    temperature, top_k, top_p, do_sample, rep_penalty, seen, guide, accum,
    horizon: int, with_mass: bool = False,
):
    """`horizon` pool steps queued back to back: nothing in them reads a
    value back, so on the card the host runs ahead of the device and the
    (H, B) token block is copied once after. EOS and guide completion are
    resolved on the host after the burst (a finished slot's tail tokens are
    dropped), so a request's output is the horizon-1 output.
    → (tokens (H, B) on the device, last tokens, cache, seen, guide, accum)."""
    toks = []
    for _ in range(horizon):
        tokens, cache, seen, guide, accum = _step_body(
            model, config, cache, tokens, generator,
            temperature, top_k, top_p, do_sample, rep_penalty, seen, guide, accum, with_mass,
        )
        toks.append(tokens)
    return torch.stack(toks), tokens, cache, seen, guide, accum


def _spec_engine_step(
    model, config, draft_model, draft_config, cache, draft_cache, tokens, generator,
    temperature, top_k, top_p, do_sample, rep_penalty, seen, guide, accum,
    gamma: int, with_mass: bool = False,
):
    """One SPECULATIVE decode step for all slots (draft and verify): the
    draft runs gamma + 1 greedy steps (proposing d1..dgamma and feeding
    t0..dgamma, so its cache stays one feed a token behind the target's
    accepted history), the target verifies [t0, d1..dgamma] in one
    (B, gamma + 1) forward, and each slot advances by its accepted n + 1.
    Greedy slots are exact against plain decoding; sampled, guided or
    penalized slots force n = 0 and take the target's sample of l0. Rows
    written past a slot's accepted length are masked by position and
    overwritten later; H2O mass of rolled-back queries is masked out.
    → (out tokens (B, gamma + 1), out count (B,), next tokens, caches,
    seen, guide, accum)."""
    apply_fn = get_apply_fn(config)
    draft_apply = get_apply_fn(draft_config)
    B = tokens.shape[0]

    tok = tokens
    proposals = []
    for _ in range(gamma + 1):
        dlogits, draft_cache = draft_apply(draft_model, draft_config, tok[:, None], draft_cache)
        tok = torch.argmax(dlogits[:, -1].to(torch.float32), dim=-1)
        proposals.append(tok)
    drafts = torch.stack(proposals[:gamma], dim=1)  # (B, gamma) = d1..dgamma

    seq = torch.cat([tokens[:, None], drafts], dim=1)  # (B, gamma + 1)
    logits, cache, mass_q = _apply_tapped(apply_fn, model, config, seq, cache, with_mass)
    logits = logits.to(torch.float32)  # (B, gamma + 1, V)
    greedy = torch.argmax(logits, dim=-1)  # g0..ggamma

    # n = the longest accepted prefix (d_{i+1} == g_i); sampling, penalty or a guide → n = 0
    ok = (drafts == greedy[:, :gamma]).to(torch.int64)
    n = torch.cumprod(ok, dim=1).sum(dim=1)  # (B,)
    spec_ok = (~do_sample) & (rep_penalty == 1.0) & (~guide.on)
    n = torch.where(spec_ok, n, 0)

    qpos = torch.arange(gamma + 1, device=tokens.device)
    if mass_q is not None:  # only accepted verify queries count toward H2O
        accum.add_(torch.where(qpos[None, :, None] <= n[:, None, None], mass_q, 0.0).sum(dim=1))

    allow, constrained = _guide_allow(guide, logits.shape[-1])
    sampled0 = sample_logits_per_slot(
        logits[:, 0], generator, temperature, top_k, top_p, do_sample, rep_penalty, seen, allow,
    )
    gn = greedy.gather(1, n[:, None])[:, 0]
    nxt = torch.where(spec_ok, gn, sampled0)
    guide = _guide_advance(guide, nxt, constrained)

    # emitted this step: d1..dn, then nxt (n + 1 tokens)
    out_tokens = torch.cat([drafts, torch.zeros((B, 1), dtype=drafts.dtype, device=drafts.device)], dim=1)
    out_tokens = torch.where(qpos[None, :] == n[:, None], nxt[:, None], out_tokens)

    # roll both caches back to the accepted history (both advanced gamma + 1)
    cache = replace(cache, length=cache.length - gamma + n)
    draft_cache = replace(draft_cache, length=draft_cache.length - gamma + n)

    # mark the emitted tokens; the rest point at out_tokens[:, 0], always emitted
    emitted = qpos[None, :] <= n[:, None]  # (B, gamma + 1)
    seen.scatter_(1, torch.where(emitted, out_tokens, out_tokens[:, :1]), True)
    return out_tokens, n + 1, nxt, cache, draft_cache, seen, guide, accum


# --------------------------- chunked prefill ---------------------------


def _fresh_slot_cache(config, max_len: int, kv_dtype, device) -> KVCache:
    """An empty single-slot cache (int length 0) on the device."""
    return init_kv_cache(config, 1, max_len, dtype=kv_dtype, device=device)


def _prefill_chunk(model, config, cache, ids, n_valid: int, seen=None, mass=None, with_mass: bool = False):
    """Prefill ONE (1, C) chunk (numpy ids) into a single-slot cache at
    [length, length + C).

    n_valid <= C real tokens; the length advances by n_valid only, so pad
    rows past it are overwritten by the next chunk (or by decode) before any
    query attends them. → (the last real token's f32 logits (V,), cache,
    seen with the chunk's tokens, mass): `last` means something only on the
    chunk holding the prompt's last token. A draft's prefill passes no
    `seen` (the target's prefill marks the tokens)."""
    apply_fn = get_apply_fn(config)
    C = ids.shape[1]
    start = cache.length
    dev = cache.k[0].device
    logits, cache, mass_q = _apply_tapped(
        apply_fn, model, config, torch.from_numpy(ids.astype(np.int64)).to(dev), cache, with_mass,
    )
    if mass_q is not None:  # Σ layers of (1, C, S): only real queries count
        mass = mass + mass_q[0, :n_valid].sum(dim=0)
    last = logits[0, min(max(n_valid - 1, 0), C - 1)].to(torch.float32)
    cache = replace(cache, length=start + n_valid)
    if seen is not None:
        # out-of-vocabulary ids mark nothing, as a one-hot of them is empty
        real = ids[0, :n_valid]
        real = real[(real >= 0) & (real < seen.shape[0])]
        seen[torch.from_numpy(real.astype(np.int64)).to(dev)] = True
    return last, cache, seen, mass


def _insert_slot(pool: KVCache, slot_cache: KVCache, slot: int, seen_all, seen_row) -> KVCache:
    """Copy a prefilled single-slot cache into pool row `slot` (k/v and, for
    int8 KV, the scale planes), with its length and seen row, in place."""
    for name in ("k", "v", "k_scale", "v_scale"):
        bl, sl = getattr(pool, name), getattr(slot_cache, name)
        if bl is not None:
            for b, s in zip(bl, sl):
                b[slot].copy_(s[0])
    pool.length[slot] = slot_cache.length
    seen_all[slot] = seen_row
    return pool


def _with_length(cache: KVCache, L: int) -> KVCache:
    """A COPY of a stored cache at a (possibly shorter) restore length. The
    JAX package shares the immutable arrays; here the tail prefill writes
    the cache in place, which would rewrite the stored entry."""
    def cp(lst):
        return None if lst is None else [t.clone() for t in lst]

    return KVCache(k=cp(cache.k), v=cp(cache.v), length=int(L), k_scale=cp(cache.k_scale),
                   v_scale=cp(cache.v_scale))


def _first_token(last_logits, generator, knobs, seen_row, allow_row):
    """The first token of a request from its prefill's last logits → (token
    (1,), seen_row with it)."""
    temperature, top_k, top_p, do_sample, rep = knobs
    tok = sample_logits_per_slot(
        last_logits[None], generator, temperature, top_k, top_p, do_sample, rep,
        seen_row[None], allow_row[None],
    )
    seen_row[tok] = True
    return tok, seen_row


# --------------------------- KV compaction ---------------------------


def _rope_spec(config):
    """(kind, rotary_dim, theta, scaling) for re-rotating kept keys; None
    for families without RoPE."""
    if hasattr(config, "pos_embedding"):  # the generic decoder's config
        if config.pos_embedding != "rope":
            return None
        kind = "interleaved" if config.rotary_interleaved else "half"
        return (kind, config.rotary_dim, config.rope_theta, None)
    return ("half", config.head_dim, config.rope_theta, config.rope_scaling)


def _rotate(kk: torch.Tensor, deltas: torch.Tensor, rope_spec) -> torch.Tensor:
    """(K, Hkv, D) f32 keys rotated by per-row position deltas (RoPE angles
    are linear in position, so one delta rotation moves a key exactly)."""
    if rope_spec is None:
        return kk
    kind, rd, theta, scaling = rope_spec
    inv = rope_inv_freq(rd, theta, scaling, device=kk.device)  # (rd/2,)
    ang = deltas.to(torch.float32)[:, None] * inv  # (K, rd/2)
    cos = torch.cos(ang)[:, None, :].to(kk.dtype)
    sin = torch.sin(ang)[:, None, :].to(kk.dtype)
    r = kk[..., :rd]
    if kind == "interleaved":  # GPT-J pairs (0, 1), (2, 3), ...
        x1, x2 = r[..., ::2], r[..., 1::2]
        rr = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(r.shape)
    else:  # half-split (llama / neox / falcon)
        x1, x2 = r.chunk(2, dim=-1)
        rr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < kk.shape[-1]:
        return torch.cat([rr, kk[..., rd:]], dim=-1)
    return rr


def _compact_cache_slot(cache: KVCache, slot: int, keep_idx: torch.Tensor, rope_spec) -> KVCache:
    """Compact ONE row of a batched cache to its kept rows, in place.

    keep_idx (K,) ascending original rows → new rows 0..K-1. Moved keys are
    re-rotated by their position delta in f32; values and rows past K stay
    (decode overwrites them under the position mask before they are
    attended). int8 caches dequantize, rotate and requantize the kept keys
    (a rotation can grow a component by up to sqrt(2)); / 127 is a product
    with the f32 reciprocal, as XLA compiles the JAX package's division.
    `cache.length` is a (B,) tensor or, for a single-row cache, an int."""
    K = keep_idx.shape[0]
    keep_idx = keep_idx.to(torch.int64)
    deltas = torch.arange(K, device=keep_idx.device) - keep_idx  # new - old <= 0
    for li in range(len(cache.k)):
        kk = cache.k[li][slot].index_select(0, keep_idx)  # (K, Hkv, D)
        vv = cache.v[li][slot].index_select(0, keep_idx)
        if cache.quantized:
            ks = cache.k_scale[li][slot].index_select(0, keep_idx)
            vs = cache.v_scale[li][slot].index_select(0, keep_idx)
            kf = _rotate(kk.to(torch.float32) * ks[..., None], deltas, rope_spec)
            inv127 = torch.full((), 1.0 / 127.0, dtype=torch.float32, device=kf.device)
            nks = kf.abs().amax(dim=-1) * inv127
            kq = torch.round(kf / nks[..., None].clamp_min(1e-8)).clamp(-127, 127).to(torch.int8)
            cache.k[li][slot, :K] = kq
            cache.k_scale[li][slot, :K] = nks
            cache.v[li][slot, :K] = vv
            cache.v_scale[li][slot, :K] = vs
        else:
            cache.k[li][slot, :K] = _rotate(kk.to(torch.float32), deltas, rope_spec).to(cache.k[li].dtype)
            cache.v[li][slot, :K] = vv
    if isinstance(cache.length, torch.Tensor):
        cache.length[slot] = K
        return cache
    return replace(cache, length=K)


def _compact_accum(accum: torch.Tensor, slot: int, keep_idx: torch.Tensor) -> torch.Tensor:
    """Row `slot` of the H2O mass moved to its kept rows, the rest zeroed (in place)."""
    K = keep_idx.shape[0]
    row = accum[slot].index_select(0, keep_idx.to(torch.int64))
    accum[slot].zero_()
    accum[slot, :K] = row
    return accum


def _compact_single(cache: KVCache, keep_idx: torch.Tensor, rope_spec) -> KVCache:
    """Compact a single-slot (int length) cache: the admission cache of a
    prompt longer than max_len under a kv_policy."""
    return _compact_cache_slot(cache, 0, keep_idx, rope_spec)


def _compact_mass(mass: torch.Tensor, keep_idx: torch.Tensor) -> torch.Tensor:
    K = keep_idx.shape[0]
    out = torch.zeros_like(mass)
    out[:K] = mass.index_select(0, keep_idx.to(torch.int64))
    return out


# ------------------------------ the engine ------------------------------


@dataclass
class EngineRequest:
    prompt_ids: np.ndarray  # (T,) int32
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = False
    repetition_penalty: float = 1.0
    eos_token_id: Optional[int] = None
    # guided choice: token sequences, one per allowed output string; every
    # emitted token must extend one of them, and the slot finishes when a
    # full sequence has been emitted
    guided_token_seqs: Optional[list] = None
    out: "queue.Queue" = field(default_factory=queue.Queue)
    cancelled: bool = field(default=False)

    _DONE = object()
    _FAILED = object()

    def cancel(self) -> None:
        """Abandon the request: its slot frees at the next decode step (a
        dropped SSE stream must not keep a slot busy)."""
        self.cancelled = True

    def tokens(self) -> Iterator[int]:
        """Blocking iterator over generated token ids; stops early when the
        request is cancelled. Raises if the engine's step thread died: a
        dead engine fails its consumers, it never hangs them."""
        while True:
            item = self.out.get()
            if item is EngineRequest._DONE:
                return
            if item is EngineRequest._FAILED:
                raise RuntimeError("DecodeEngine step thread died; see engine.fatal_error")
            yield item


class DecodeEngine:
    """Slot-based continuous-batching generation engine (module docstring).

    `model` is the port's `LlamaModel` (float or quantized) on `device`,
    which is the card unless the caller names one."""

    def __init__(
        self,
        model,
        config,
        *,
        max_slots: int = 8,
        max_len: int = 1024,
        prefill_chunk: int = 128,
        seed: int = 0,
        draft_model=None,
        draft_config=None,
        num_speculative_tokens: int = 4,
        kv_dtype="bfloat16",  # "int8": half the KV memory, about twice the slots
        kv_policy: Optional[str] = None,  # None | "sink" | "h2o"
        kv_sink: int = 4,
        kv_recent: Optional[int] = None,
        kv_heavy: Optional[int] = None,
        pp_state=None,
        decode_horizon: int = 1,  # pool steps a dispatch (>= 1)
        prefix_cache: int = 0,  # cached prompt-prefix entries (0 = off)
        prefix_cache_min_tokens: int = 16,  # shorter prompts are not stored
        max_admissions: int = 2,  # chunked admissions in flight
        device=None,
    ):
        if pp_state is not None:
            raise NotImplementedError(
                "pipeline-parallel serving (parallel/pp_serve.py) is not ported yet "
                "(ROADMAP queue 1, step 7)"
            )
        self.device = resolve_device(device)
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is None:
                continue
            on = next(m.parameters()).device
            if on.type != self.device.type:
                raise ValueError(f"the {what} lies on {on}; the engine runs on {self.device}")
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        self.model = model
        self.config = config
        self.max_slots = max_slots
        self.max_len = max_len
        # a chunk wider than the cache could not be written into it
        self.prefill_chunk = max(1, min(int(prefill_chunk), max_len))
        self.draft_model = draft_model
        self.draft_config = draft_config
        self.gamma = int(num_speculative_tokens)
        if (draft_model is None) != (draft_config is None):
            raise ValueError("draft_model and draft_config go together")
        # a speculative step already emits up to gamma + 1 tokens
        self.decode_horizon = (
            1 if draft_config is not None else max(1, min(int(decode_horizon), max_len))
        )
        V = config.vocab_size

        self.kv_dtype = kv_dtype
        self._kv = _KV_DTYPES[kv_dtype]
        if kv_policy not in (None, "sink", "h2o"):
            raise ValueError(f"unknown kv_policy {kv_policy!r}")
        self.kv_policy = kv_policy
        self.kv_sink = int(kv_sink)
        self.kv_recent = int(kv_recent) if kv_recent is not None else max_len // 2
        self.kv_heavy = int(kv_heavy) if kv_heavy is not None else max_len // 4
        step_w = self.gamma + 1 if draft_config is not None else self.decode_horizon
        if kv_policy is not None:
            keep = self.kv_recent + (self.kv_sink if kv_policy == "sink" else self.kv_heavy)
            if keep + step_w > max_len:
                raise ValueError(
                    f"kv_policy keep size {keep} + step width {step_w} exceeds max_len {max_len}"
                )
            # long-prompt admission compacts to `keep` rows between chunks;
            # a chunk must still fit afterwards
            self.prefill_chunk = min(self.prefill_chunk, max_len - keep)
        self._with_mass = kv_policy == "h2o"

        # the prompt-prefix cache: finished admissions' prompt caches, LRU;
        # each entry holds one slot cache of device memory
        self.prefix_cache = int(prefix_cache)
        self.prefix_cache_min_tokens = max(2, int(prefix_cache_min_tokens))
        self._prefix_lru: "OrderedDict[bytes, dict]" = OrderedDict()
        self._prefix_mu = threading.Lock()  # warm_prefix runs on the caller's thread
        self._prefix_hits = 0
        self._prefix_tokens_reused = 0

        dev = self.device

        def pool_cache(cfg):
            c = init_kv_cache(cfg, max_slots, max_len, dtype=self._kv, device=dev)
            return replace(c, length=torch.zeros((max_slots,), dtype=torch.int64, device=dev))

        self._cache = pool_cache(config)
        self._draft_cache = pool_cache(draft_config) if draft_config is not None else None
        self._tokens = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        self._seen = torch.zeros((max_slots, V), dtype=torch.bool, device=dev)
        self._accum = torch.zeros((max_slots, max_len), dtype=torch.float32, device=dev)
        self._guide = GuideState(
            seqs=torch.full((max_slots, 1, 1), -1, dtype=torch.int64, device=dev),
            active=torch.zeros((max_slots, 1), dtype=torch.bool, device=dev),
            pos=torch.zeros((max_slots,), dtype=torch.int64, device=dev),
            on=torch.zeros((max_slots,), dtype=torch.bool, device=dev),
        )
        self._guides: list = [None] * max_slots  # host mirrors (completion)
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        # per-slot sampling knobs: host mirrors, uploaded when a slot (re)joins
        self._temp = np.ones((max_slots,), np.float32)
        self._topk = np.zeros((max_slots,), np.int64)
        self._topp = np.ones((max_slots,), np.float32)
        self._dos = np.zeros((max_slots,), bool)
        self._rep = np.ones((max_slots,), np.float32)
        self._knobs_dev: Optional[tuple] = None

        self._slots: list[Optional[EngineRequest]] = [None] * max_slots
        self._emitted = np.zeros((max_slots,), np.int64)
        self._host_len = np.zeros((max_slots,), np.int64)  # cache-length mirror
        self._total_tokens = 0  # emitted tokens since start
        self._total_requests = 0  # completed requests
        self._pending: "queue.Queue[EngineRequest]" = queue.Queue()
        # in-flight chunked admissions, each into its own reserved slot; their
        # chunks are issued behind the pool step
        self.max_admissions = max(1, int(max_admissions))
        self._adms: list[dict] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fatal_error: Optional[BaseException] = None
        self._steps = 0  # pool dispatches
        self._compactions = 0  # KV evictions
        self._chunks = 0  # prefill chunks

    # ------------------------------ public ------------------------------

    def start(self) -> "DecodeEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def submit(self, request: EngineRequest) -> EngineRequest:
        """Enqueue a request; its `tokens()` iterator yields as soon as a slot
        frees up. Thread-safe."""
        if self.fatal_error is not None:
            raise RuntimeError("DecodeEngine step thread died") from self.fatal_error
        request.prompt_ids = np.asarray(request.prompt_ids, np.int32).reshape(-1)
        if self.kv_policy is None and len(request.prompt_ids) >= self.max_len:
            # with a kv_policy the admission compacts between prefill chunks
            raise ValueError(f"prompt length {len(request.prompt_ids)} ≥ max_len {self.max_len}")
        self._pending.put(request)
        if self.fatal_error is not None:
            # the step thread may have died between the check and the put
            self._fail_pending()
        self._wake.set()
        return request

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def stats(self) -> dict:
        """Serving counters for the /v1/stats endpoint."""
        return {
            "active_slots": self.active_slots,
            "max_slots": self.max_slots,
            "queued": self._pending.qsize(),
            "decode_steps": self._steps,
            "total_tokens": self._total_tokens,
            "completed_requests": self._total_requests,
            "speculative": self._draft_cache is not None,
            "decode_horizon": self.decode_horizon,
            "max_admissions": self.max_admissions,
            "inflight_admissions": len(self._adms),
            "kv_dtype": str(self.kv_dtype),
            "kv_policy": self.kv_policy or "none",
            "kv_compactions": self._compactions,
            "prefill_chunks": self._chunks,
            "prefix_cache_entries": len(self._prefix_lru),
            "prefix_cache_hits": self._prefix_hits,
            "prefix_tokens_reused": self._prefix_tokens_reused,
        }

    # ----------------------- prompt-prefix cache -----------------------

    def _prefix_lookup(self, ids: np.ndarray):
        """→ (entry, rows) for the longest stored prompt that is a prefix of
        `ids`, capped at len(ids) - 1 (the last prompt token is prefilled for
        the first token's logits). (None, 0) on a miss."""
        best, best_rows = None, 0
        with self._prefix_mu:
            for entry in self._prefix_lru.values():
                p = entry["ids"]
                rows = min(len(p), len(ids) - 1)
                if rows <= best_rows:
                    continue
                if self._draft_cache is not None and entry.get("dcache") is None:
                    continue  # draft and target caches restore together
                if np.array_equal(p[:rows], ids[:rows]):
                    best, best_rows = entry, rows
            if best is not None:
                self._prefix_lru.move_to_end(best["key"])
        return best, best_rows

    def _prefix_store(self, adm: dict) -> None:
        ids = adm["prompt"]
        if (
            not self.prefix_cache
            or adm["cache"] is None
            or adm["compacted"]  # its rows no longer match its tokens
            or len(ids) < self.prefix_cache_min_tokens
        ):
            return
        key = ids.tobytes()
        with self._prefix_mu:
            # the admission's cache is written no more once stored: a hit copies it
            self._prefix_lru[key] = {
                "key": key,
                "ids": ids,
                "cache": adm["cache"],
                "dcache": adm["dcache"],
                "mass": adm["mass"] if self._with_mass else None,
            }
            self._prefix_lru.move_to_end(key)
            while len(self._prefix_lru) > self.prefix_cache:
                self._prefix_lru.popitem(last=False)

    @torch.no_grad()
    def warm_prefix(self, prompt_ids) -> int:
        """Prefill `prompt_ids` into the prefix cache without generating (a
        system prompt at server start). → rows cached."""
        if not self.prefix_cache:
            return 0
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(ids) < self.prefix_cache_min_tokens:
            return 0
        cache = _fresh_slot_cache(self.config, self.max_len, self._kv, self.device)
        dcache = (
            _fresh_slot_cache(self.draft_config, self.max_len, self._kv, self.device)
            if self._draft_cache is not None else None
        )
        seen = torch.zeros((self.config.vocab_size,), dtype=torch.bool, device=self.device)
        mass = torch.zeros((self.max_len,), dtype=torch.float32, device=self.device)
        C = self.prefill_chunk
        t = min(len(ids), self.max_len - 1)
        ids = ids[:t]
        nc = max(1, -(-t // C))
        padded = np.zeros((nc * C,), np.int32)
        padded[:t] = ids
        for i in range(nc):
            chunk = padded[i * C:(i + 1) * C][None]
            nv = max(0, min(C, t - i * C))
            _, cache, seen, mass = _prefill_chunk(
                self.model, self.config, cache, chunk, nv, seen, mass, with_mass=self._with_mass,
            )
            if dcache is not None:
                _, dcache, _, _ = _prefill_chunk(self.draft_model, self.draft_config, dcache, chunk, nv)
        self._prefix_store({"prompt": ids, "cache": cache, "dcache": dcache, "mass": mass,
                            "compacted": False})
        return t

    # --------------------------- admission ---------------------------

    def _begin_admission(self, req: EngineRequest, slot: int) -> None:
        ids = np.asarray(req.prompt_ids, np.int32).reshape(-1)
        t = len(ids)
        C = self.prefill_chunk
        V = self.config.vocab_size
        restored, entry = 0, None
        if self.prefix_cache:
            entry, restored = self._prefix_lookup(ids)
            # chunk-align the restore point, so the tail chunks write the
            # same windows as a prefill from row 0 would; rows of the partial
            # block are prefilled again from the same tokens
            restored = (restored // C) * C
            if restored == 0:
                entry = None
        tail = ids[restored:]
        tt = len(tail)
        nc = max(1, -(-tt // C))
        padded = np.zeros((nc * C,), np.int32)
        padded[:tt] = tail
        adm = {
            "req": req,
            "slot": slot,
            "prompt": ids,
            "compacted": False,  # a cache compacted while admitting is not stored
            "chunks": [padded[i * C:(i + 1) * C][None] for i in range(nc)],
            "n_valids": [max(0, min(C, tt - i * C)) for i in range(nc)],
            "ci": 0,
            "cache": None,
            "dcache": None,
            "seen": torch.zeros((V,), dtype=torch.bool, device=self.device),
            "mass": torch.zeros((self.max_len,), dtype=torch.float32, device=self.device),
            "last": None,
            "len": 0,  # true tokens prefilled so far (compaction-aware)
        }
        if restored:
            # a copy of the stored rows at `restored`; rows past it are stale
            # but masked by position and rewritten by the tail chunks
            adm["cache"] = _with_length(entry["cache"], restored)
            if self._draft_cache is not None and entry.get("dcache") is not None:
                adm["dcache"] = _with_length(entry["dcache"], restored)
            seen_np = np.zeros((V,), bool)
            toks = ids[:restored]
            # out-of-vocabulary ids mark nothing, as in the prefill
            seen_np[toks[(toks >= 0) & (toks < V)]] = True
            adm["seen"] = torch.from_numpy(seen_np).to(self.device)
            if self._with_mass and entry.get("mass") is not None:
                keep = torch.arange(self.max_len, device=self.device) < restored
                adm["mass"] = torch.where(keep, entry["mass"], 0.0)
            adm["len"] = restored
            self._prefix_hits += 1
            self._prefix_tokens_reused += restored
        if adm["cache"] is None:
            adm["cache"] = _fresh_slot_cache(self.config, self.max_len, self._kv, self.device)
        if self._draft_cache is not None and adm["dcache"] is None:
            adm["dcache"] = _fresh_slot_cache(self.draft_config, self.max_len, self._kv, self.device)
        self._adms.append(adm)

    def _admission_step(self, adm: dict) -> bool:
        """Prefill ONE chunk of an in-flight admission; after the last one,
        sample the first token and activate the slot. → True when the
        admission is finished (done or cancelled)."""
        req: EngineRequest = adm["req"]
        if req.cancelled:
            req.out.put(EngineRequest._DONE)
            return True
        ci = adm["ci"]
        C = adm["chunks"][ci].shape[1]
        if self.kv_policy is not None and adm["len"] + C > self.max_len:
            # long-prompt ingestion: evict between prefill chunks, so prompts
            # of any length stream through a bounded cache
            keep = self._keep_indices(adm["len"], adm["mass"] if self._with_mass else None)
            keep_idx = torch.from_numpy(keep.astype(np.int64)).to(self.device)
            adm["cache"] = _compact_single(adm["cache"], keep_idx, _rope_spec(self.config))
            if adm["dcache"] is not None:
                adm["dcache"] = _compact_single(adm["dcache"], keep_idx, _rope_spec(self.draft_config))
            if self._with_mass:
                adm["mass"] = _compact_mass(adm["mass"], keep_idx)
            adm["len"] = len(keep)
            adm["compacted"] = True
            self._compactions += 1
        ids = adm["chunks"][ci]
        nv = adm["n_valids"][ci]
        adm["last"], adm["cache"], adm["seen"], adm["mass"] = _prefill_chunk(
            self.model, self.config, adm["cache"], ids, nv, adm["seen"], adm["mass"],
            with_mass=self._with_mass,
        )
        if adm["dcache"] is not None:
            _, adm["dcache"], _, _ = _prefill_chunk(
                self.draft_model, self.draft_config, adm["dcache"], ids, nv,
            )
        self._chunks += 1
        adm["len"] += nv
        adm["ci"] = ci + 1
        if adm["ci"] < len(adm["chunks"]):
            return False
        self._finish_admission(adm)
        return True

    def _step_admissions(self) -> None:
        """One prefill chunk for EACH in-flight admission, called right after
        the pool dispatch: on the card the chunks queue behind it."""
        # by identity: the JAX package's list.remove compares the admission
        # dicts with ==, which fails on their arrays once two are in flight
        done = [adm for adm in self._adms if self._admission_step(adm)]
        self._adms = [adm for adm in self._adms if not any(adm is d for d in done)]

    def _finish_admission(self, adm: dict) -> None:
        req: EngineRequest = adm["req"]
        slot = adm["slot"]
        dev = self.device
        self._prefix_store(adm)
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._dos[slot] = req.do_sample
        self._rep[slot] = req.repetition_penalty
        self._knobs_dev = None  # uploaded again before the next pool step
        knobs = (
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int64, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            torch.tensor([bool(req.do_sample)], dtype=torch.bool, device=dev),
            torch.tensor([req.repetition_penalty], dtype=torch.float32, device=dev),
        )
        guide = None
        if req.guided_token_seqs:
            seqs = [list(map(int, s)) for s in req.guided_token_seqs if len(s)]
            if seqs:
                guide = {"seqs": seqs, "active": [True] * len(seqs), "pos": 0}
        self._guides[slot] = guide
        # the first token's allow row, built once on the host; every later
        # step derives the mask on the device from the GuideState
        V = self.config.vocab_size
        row = np.ones((V,), bool)
        if guide is not None:
            row[:] = False
            for s in guide["seqs"]:
                row[s[0]] = True
        allow_row = torch.from_numpy(row).to(dev)
        tok, seen_row = _first_token(adm["last"], self._generator, knobs, adm["seen"], allow_row)
        self._cache = _insert_slot(self._cache, adm["cache"], slot, self._seen, seen_row)
        if adm["dcache"] is not None:
            self._draft_cache = _insert_slot(self._draft_cache, adm["dcache"], slot, self._seen, seen_row)
        if self._with_mass:
            self._accum[slot] = adm["mass"]
        self._tokens[slot] = tok[0]
        self._slots[slot] = req
        self._emitted[slot] = 0
        self._host_len[slot] = adm["len"]
        # the prefill gave the first token: emit it, advance the host guide
        # mirror, then write the slot's device GuideState row once
        t = int(tok[0])
        self._emit(slot, t)
        self._advance_guide_mirror(slot, t)
        self._sync_guide_row(slot)

    # --------------------------- guided choice ---------------------------

    def _guide_caps(self) -> tuple[int, int]:
        return self._guide.seqs.shape[1], self._guide.seqs.shape[2]

    def _grow_guide(self, n_seqs: int, n_len: int) -> None:
        """High-water-mark growth of the device guide tensors."""
        S0, L0 = self._guide_caps()
        S1, L1 = max(S0, n_seqs), max(L0, n_len)
        if (S1, L1) == (S0, L0):
            return
        seqs = torch.full((self.max_slots, S1, L1), -1, dtype=torch.int64, device=self.device)
        seqs[:, :S0, :L0] = self._guide.seqs
        active = torch.zeros((self.max_slots, S1), dtype=torch.bool, device=self.device)
        active[:, :S0] = self._guide.active
        self._guide = GuideState(seqs=seqs, active=active, pos=self._guide.pos, on=self._guide.on)

    def _sync_guide_row(self, slot: int) -> None:
        """Write one slot's guide mirror into the device GuideState (on slot
        transitions only: admission, completion, termination)."""
        g = self._guides[slot]
        if g is None:
            self._guide.on[slot] = False
            return
        self._grow_guide(len(g["seqs"]), max(len(s) for s in g["seqs"]))
        S, L = self._guide_caps()
        row = np.full((S, L), -1, np.int64)
        act = np.zeros((S,), bool)
        for i, s in enumerate(g["seqs"]):
            row[i, : len(s)] = s
            act[i] = g["active"][i]
        self._guide.seqs[slot] = torch.from_numpy(row).to(self.device)
        self._guide.active[slot] = torch.from_numpy(act).to(self.device)
        self._guide.pos[slot] = g["pos"]
        self._guide.on[slot] = True

    def _advance_guide_mirror(self, slot: int, token: int) -> None:
        """Mirror the device-side `_guide_advance` on the host and finish
        the slot on the shortest complete match (the host owns slot
        lifecycles)."""
        if self._slots[slot] is None:
            if self._guides[slot] is not None:  # the slot ended some other way
                self._guides[slot] = None
                self._sync_guide_row(slot)
            return
        g = self._guides[slot]
        if g is None:
            return
        pos = g["pos"]
        if not any(a and len(s) > pos for a, s in zip(g["active"], g["seqs"])):
            return
        g["active"] = [a and len(s) > pos and s[pos] == token for a, s in zip(g["active"], g["seqs"])]
        g["pos"] = pos + 1
        complete = (not any(g["active"])) or any(
            a and len(s) == g["pos"] for a, s in zip(g["active"], g["seqs"])
        )
        if complete:
            self._slots[slot].out.put(EngineRequest._DONE)
            self._slots[slot] = None
            self._total_requests += 1
            self._guides[slot] = None
            self._sync_guide_row(slot)

    # --------------------------- KV eviction ---------------------------

    def _step_width(self) -> int:
        """The most cache rows one dispatch can take a slot."""
        if self._draft_cache is not None:
            return self.gamma + 1
        return self.decode_horizon

    def _keep_indices(self, old_len: int, accum_row=None) -> np.ndarray:
        """The policy's kept rows (ascending) of a cache of old_len rows."""
        recent = min(self.kv_recent, old_len)
        if self.kv_policy == "sink":
            sink = min(self.kv_sink, old_len - recent)
            return np.concatenate([np.arange(sink), np.arange(old_len - recent, old_len)])
        acc = accum_row[:old_len].cpu().numpy()
        rs = old_len - recent
        heavy = min(self.kv_heavy, rs)
        hv = np.sort(np.argpartition(acc[:rs], -heavy)[-heavy:]) if heavy else np.empty((0,), np.int64)
        return np.concatenate([hv, np.arange(rs, old_len)])

    def _maybe_compact(self) -> None:
        """Compact each active slot whose next dispatch would overflow its
        cache (kv_policy only); the host picks the kept rows."""
        if self.kv_policy is None:
            return
        w = self._step_width()
        for slot in range(self.max_slots):
            if self._slots[slot] is None or self._host_len[slot] + w <= self.max_len:
                continue
            keep = self._keep_indices(int(self._host_len[slot]),
                                      self._accum[slot] if self._with_mass else None)
            keep_idx = torch.from_numpy(keep.astype(np.int64)).to(self.device)
            self._cache = _compact_cache_slot(self._cache, slot, keep_idx, _rope_spec(self.config))
            if self._draft_cache is not None:
                self._draft_cache = _compact_cache_slot(
                    self._draft_cache, slot, keep_idx, _rope_spec(self.draft_config)
                )
            if self._with_mass:
                self._accum = _compact_accum(self._accum, slot, keep_idx)
            self._host_len[slot] = len(keep)
            self._compactions += 1

    # ------------------------------ internals ------------------------------

    def _device_knobs(self) -> tuple:
        """The per-slot sampling knobs on the device, uploaded again only
        after a slot (re)joins."""
        if self._knobs_dev is None:
            self._knobs_dev = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (self._temp, self._topk, self._topp, self._dos, self._rep)
            )
        return self._knobs_dev

    def _emit_burst(self, active: list, toks: np.ndarray) -> None:
        """Emit an (H, B) burst of decoded tokens in step order. A slot that
        finishes mid-burst has its tail tokens dropped (its cache rows past
        the end are dead), so a request's output is the horizon-1 output."""
        H = toks.shape[0]
        for slot in range(self.max_slots):
            if active[slot]:
                self._host_len[slot] += H
        for h in range(H):
            for slot in range(self.max_slots):
                if active[slot] and self._slots[slot] is not None:
                    t = int(toks[h, slot])
                    self._emit(slot, t)
                    self._advance_guide_mirror(slot, t)

    def _emit(self, slot: int, token: int) -> None:
        req = self._slots[slot]
        if req is None:
            return
        done = False
        if req.cancelled:
            done = True
        elif req.eos_token_id is not None and token == req.eos_token_id:
            done = True
        else:
            req.out.put(token)
            self._emitted[slot] += 1
            self._total_tokens += 1
            if self._emitted[slot] >= req.max_new_tokens:
                done = True
        # without an eviction policy a slot ends when its cache is full (a
        # speculative step writes up to gamma + 1 rows at once, so it needs
        # that much room); with one the slot compacts instead
        if (
            not done
            and self.kv_policy is None
            and self._emitted[slot] + len(req.prompt_ids) >= self.max_len - self._step_width()
        ):
            done = True
        if done:
            req.out.put(EngineRequest._DONE)
            self._slots[slot] = None
            self._total_requests += 1
            if self._guides[slot] is not None:
                self._guides[slot] = None
                self._sync_guide_row(slot)

    def _fail_pending(self) -> None:
        try:
            while True:
                self._pending.get_nowait().out.put(EngineRequest._FAILED)
        except queue.Empty:
            pass

    def _loop(self) -> None:
        """The step thread: run the loop; if it dies, fail every waiting
        consumer at once instead of leaving them blocked on queues that will
        never fill."""
        try:
            with torch.no_grad():
                self._loop_inner()
        except Exception as exc:  # noqa: BLE001 — anything fatal
            self.fatal_error = exc
            logger.exception("engine step thread died")
            for slot, req in enumerate(self._slots):
                if req is not None:
                    req.out.put(EngineRequest._FAILED)
                    self._slots[slot] = None
            for adm in self._adms:
                adm["req"].out.put(EngineRequest._FAILED)
            self._adms = []
            self._fail_pending()

    def _admit_pending(self) -> None:
        """Begin admissions into free, unreserved slots, up to max_admissions
        in flight."""
        while len(self._adms) < self.max_admissions:
            reserved = {a["slot"] for a in self._adms}
            slot = next(
                (s for s in range(self.max_slots) if self._slots[s] is None and s not in reserved), -1
            )
            if slot < 0:
                return
            try:
                req = self._pending.get_nowait()
                while req.cancelled:  # dropped before admission
                    req.out.put(EngineRequest._DONE)
                    req = self._pending.get_nowait()
            except queue.Empty:
                return
            self._begin_admission(req, slot)

    def _loop_inner(self) -> None:
        while not self._stop.is_set():
            self._admit_pending()
            active = [s is not None for s in self._slots]
            if not any(active):
                # an idle pool: drive the admissions directly, one chunk each
                if self._adms:
                    self._step_admissions()
                    continue
                if self._pending.empty():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            self._maybe_compact()
            knobs = self._device_knobs()
            if self._draft_cache is not None:
                (out_tokens, out_count, self._tokens, self._cache, self._draft_cache,
                 self._seen, self._guide, self._accum) = _spec_engine_step(
                    self.model, self.config, self.draft_model, self.draft_config,
                    self._cache, self._draft_cache, self._tokens, self._generator, *knobs,
                    self._seen, self._guide, self._accum, self.gamma, self._with_mass,
                )
                self._steps += 1
                self._step_admissions()  # the chunks queue behind the dispatch
                ot, oc = out_tokens.cpu().numpy(), out_count.cpu().numpy()
                for slot in range(self.max_slots):
                    # a slot admitted behind this step holds no token of it (the
                    # JAX package emits the empty row's into the new request)
                    if not active[slot]:
                        continue
                    self._host_len[slot] += int(oc[slot])
                    for j in range(int(oc[slot])):
                        if self._slots[slot] is None:
                            break  # EOS or the limit mid-step: drop the tail
                        t = int(ot[slot, j])
                        self._emit(slot, t)
                        self._advance_guide_mirror(slot, t)
                continue
            (toks, self._tokens, self._cache, self._seen, self._guide,
             self._accum) = _engine_step_multi(
                self.model, self.config, self._cache, self._tokens, self._generator, *knobs,
                self._seen, self._guide, self._accum, self.decode_horizon, self._with_mass,
            )
            self._steps += 1
            self._step_admissions()  # the chunks queue behind the burst
            self._emit_burst(active, toks.cpu().numpy())

    # ----------------------------- conveniences -----------------------------

    def generate(self, prompt_ids, **kw) -> list[int]:
        """Blocking single request → list of token ids."""
        req = self.submit(EngineRequest(np.asarray(prompt_ids, np.int32), **kw))
        return list(req.tokens())
