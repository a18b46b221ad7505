"""IVF scans over packed residual lists: the global top-k scan (K6) and the
per-list candidate scan (K7).

Port of `intel_extension_for_transformers_tpu/ops/ivf_scan.py`. An IVF
index stores each list as `L_pad` rows of group-scaled int4 or int8 residual
codes (vector minus its list's centroid), bf16 group scales and row ids (-1 =
empty). A row's score against a query is

    q·centroid (f32) + Σ bf16(q)·bf16(code·scale), f32 sums,

where the residual is rounded to bf16 as the JAX package's decode does, and
the refine tier's hi-nibble plane decodes `code` as `16·hi + 8`
(`code_mult`, `code_offset`). K6 (`csrc/ivf_scan.cu`) reads each probed
list once per query, decodes and scores it in registers and keeps the top-k
in shared memory; no (B, nprobe·L, D) decode ever reaches device memory.

The contract is the JAX package's:

- `ivf_scan_topk` → (scores (B, k) f32, ids (B, k) int32) over the probed
  lists, ranked by score, equal scores by the highest id. A list a query
  probes twice counts once. `track_positions=True` returns flat storage
  positions `list·L_pad + slot` instead of row ids.
- `ivf_scan_candidates` → (scores (B, nprobe·t), positions (B, nprobe·t)):
  for each probe slot, the top-t rows of that list by the score without the
  base (equal scores by the highest position), then the base added back; a
  repeated probe repeats its list's candidates, as in the JAX wrapper's
  probe-slot mapping.
- An empty output slot is (-inf, -1). Inside the TPU kernels a masked score
  is the finite -1e30 (their 0/1 selection dots would turn -inf into NaN);
  here masked rows simply never enter a top-k.

Not ported: `max_id` and `m_rows`, which drive the TPU kernel's MXU
member-compaction merge and `_member_selector`, and `interpret`, Pallas's
CPU mode; the TPU wrapper's padding of the batch to a multiple of 8 is TPU
tiling and does not show here. The TPU kernel's merge skips a tile when no
query's best beats its k-th score strictly, so on an exact tie at the k-th
score it can keep the lower id; the port keeps the highest id everywhere.

On a CPU tensor each dispatcher runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

__all__ = [
    "choose_blocking",
    "decode_residual",
    "ivf_scan_topk",
    "ivf_scan_topk_plain",
    "ivf_scan_topk_cuda",
    "ivf_scan_candidates",
    "ivf_scan_candidates_plain",
    "ivf_scan_candidates_cuda",
]

MAX_K = 256  # the kernels' top-k lives in 2^ceil(log2(k + 256)) shared-memory slots
_TILE = 256  # list rows the kernels score between two merges (csrc/ivf_scan.cu kTile)
_SMEM_LIMIT = 48 * 1024  # static launch limit: D·4 + slots·8 bytes
_PLAIN_ELEMENTS = 1 << 27  # decoded elements per query block in the plain versions


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def choose_blocking(list_cap: int, l_blk_max: int = 1536, overhead_rows: int = 768) -> tuple[int, int]:
    """→ (l_blk, l_pad): the TPU scan's sub-block size and the padded list cap.

    Kept bit-for-bit from the JAX package because it fixes `L_pad`, and so
    every storage position: the cost charges each block its rows (l_pad in
    all) plus `overhead_rows` of fixed step cost, l_blk a multiple of 128 and
    at most `l_blk_max`."""
    best = None
    for n_sub in range(1, 256):
        l_blk = _round_up(-(-list_cap // n_sub), 128)
        if l_blk > l_blk_max:
            continue
        l_pad = n_sub * l_blk
        key = (l_pad + n_sub * overhead_rows, n_sub)
        if best is None or key < best[0]:
            best = (key, l_blk, l_pad)
    if best is None:  # cap larger than 256 blocks of l_blk_max
        return l_blk_max, _round_up(list_cap, l_blk_max)
    return best[1], best[2]


def _signed_nibbles(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 bytes (sign-extended from int8) → their (low, high) nibbles as
    signed int4 values. IVF codes pack adjacent columns: byte w holds column
    2w in the low nibble and 2w+1 in the high one (not the khalf layout of
    `ops/packing.py`)."""
    lo = p & 0xF
    return torch.where(lo >= 8, lo - 16, lo), p >> 4


def decode_residual(codes, scales, group_size: int, bits: int, code_mult: int = 1, code_offset: int = 0):
    """codes (..., W) int8, scales (..., G) → residuals (..., D) bf16.

    Each value is bf16(code·code_mult + code_offset) times the bf16 scale,
    rounded to bf16: the JAX package's decode (`retrieval/ivf.py
    ::_decode_residual`), which K6, K7 and the materializing search share."""
    p = codes.to(torch.int32)
    if bits == 4:
        lo, hi = _signed_nibbles(p)
        q = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], 2 * p.shape[-1])
    else:
        q = p
    if code_mult != 1 or code_offset != 0:
        q = q * code_mult + code_offset
    G = scales.shape[-1]
    r = q.reshape(*q.shape[:-1], G, q.shape[-1] // G).to(torch.float32)
    r = (r * scales.to(torch.float32)[..., None]).to(torch.bfloat16)  # exact product, one rounding
    return r.reshape(*q.shape)


def _check_storage(q, packed, scales, row_ids, probes, bits, group_size, l_blk):
    B, D = q.shape
    C, L, W = packed.shape
    if W != (D // 2 if bits == 4 else D) or bits not in (4, 8):
        raise ValueError(f"packed rows of {W} bytes do not hold {bits}-bit codes of dim {D}")
    if scales.shape != (C, L, D // group_size) or D % group_size:
        raise ValueError(f"scales {tuple(scales.shape)} do not match ({C}, {L}, {D}/{group_size})")
    if row_ids.shape != (C, L):
        raise ValueError(f"row_ids {tuple(row_ids.shape)} do not match ({C}, {L})")
    if probes.ndim != 2 or probes.shape[0] != B:
        raise ValueError(f"probes {tuple(probes.shape)} do not match the batch of {B}")
    if L % l_blk:
        raise ValueError(f"list cap {L} is not a multiple of l_blk {l_blk} (see choose_blocking)")


def _dedup_probes(probes: torch.Tensor) -> torch.Tensor:
    """(B, nprobe) → the same lists sorted, each query's repeats set to -1."""
    srt = torch.sort(probes.to(torch.int64), dim=1).values
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return torch.where(dup, -1, srt)


def _best_first(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k along the last dim, ranked by score, equal scores by the highest
    id; (-inf, -1) entries sort last and pad a short row."""
    order = torch.argsort(ids, dim=-1, descending=True, stable=True)
    scores, ids = torch.gather(scores, -1, order), torch.gather(ids, -1, order)
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)[..., :k]
    scores, ids = torch.gather(scores, -1, order), torch.gather(ids, -1, order)
    short = k - scores.shape[-1]
    if short > 0:
        scores = torch.nn.functional.pad(scores, (0, short), value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, short), value=-1)
    return scores, ids


def _list_scores(qb, lists, packed, scales, row_ids, *, bits, group_size, code_mult, code_offset, track_positions):
    """(b, P) probed lists (-1 = skip) → (b, P, L) residual dot scores (no
    base), ids (row ids or flat positions), -inf / -1 where masked."""
    L = packed.shape[1]
    safe = lists.clamp_min(0)
    resid = decode_residual(packed[safe], scales[safe], group_size, bits, code_mult, code_offset)
    s = torch.einsum("bd,bpld->bpl", qb, resid.to(torch.float32))  # exact bf16 products, f32 sums
    rid = row_ids[safe]
    valid = (rid >= 0) & (lists >= 0)[..., None]
    if track_positions:
        ids = safe[..., None] * L + torch.arange(L, device=safe.device)
    else:
        ids = rid.to(torch.int64)
    return torch.where(valid, s, -torch.inf), torch.where(valid, ids, -1)


def _blocks(B: int, per_query: int):
    step = max(1, _PLAIN_ELEMENTS // max(per_query, 1))
    return range(0, B, step), step


def ivf_scan_topk_plain(q, centroids, packed, scales, row_ids, probes, *, k: int, bits: int,
                        group_size: int, l_blk: int, track_positions: bool = False,
                        code_mult: int = 1, code_offset: int = 0):
    """K6's plain PyTorch version: decodes a block of queries' probed lists
    at a time and ranks them with two stable sorts."""
    _check_storage(q, packed, scales, row_ids, probes, bits, group_size, l_blk)
    qf = q.to(torch.float32)
    csims = qf @ centroids.to(torch.float32).T  # (B, C) f32
    qb = qf.to(torch.bfloat16).to(torch.float32)
    lists = _dedup_probes(probes)
    L, D = packed.shape[1], q.shape[1]
    out_s, out_i = [], []
    starts, step = _blocks(q.shape[0], lists.shape[1] * L * D)
    for b0 in starts:
        lst = lists[b0 : b0 + step]
        s, ids = _list_scores(qb[b0 : b0 + step], lst, packed, scales, row_ids, bits=bits,
                              group_size=group_size, code_mult=code_mult,
                              code_offset=code_offset, track_positions=track_positions)
        base = torch.gather(csims[b0 : b0 + step], 1, lst.clamp_min(0))
        s = s + base[..., None]  # -inf stays -inf
        bs, bi = _best_first(s.flatten(1), ids.flatten(1), k)
        out_s.append(bs)
        out_i.append(bi)
    return torch.cat(out_s), torch.cat(out_i).to(torch.int32)


def ivf_scan_candidates_plain(q, centroids, packed, scales, row_ids, probes, *, t: int, bits: int,
                              group_size: int, l_blk: int, code_mult: int = 1, code_offset: int = 0):
    """K7's plain PyTorch version."""
    _check_storage(q, packed, scales, row_ids, probes, bits, group_size, l_blk)
    qf = q.to(torch.float32)
    csims = qf @ centroids.to(torch.float32).T
    qb = qf.to(torch.bfloat16).to(torch.float32)
    lists = probes.to(torch.int64)
    L, D = packed.shape[1], q.shape[1]
    out_s, out_p = [], []
    starts, step = _blocks(q.shape[0], lists.shape[1] * L * D)
    for b0 in starts:
        s, pos = _list_scores(qb[b0 : b0 + step], lists[b0 : b0 + step], packed, scales, row_ids,
                              bits=bits, group_size=group_size, code_mult=code_mult,
                              code_offset=code_offset, track_positions=True)
        bs, bp = _best_first(s, pos, t)
        out_s.append(bs)
        out_p.append(bp)
    s, pos = torch.cat(out_s), torch.cat(out_p)
    return _add_base(s, pos, csims, lists)


def _add_base(s, pos, csims, probes):
    """(B, nprobe, t) base-free list scores → (B, nprobe·t) scores with the
    probe's q·centroid added, -inf where there is no candidate."""
    base = torch.gather(csims, 1, probes.to(torch.int64))[..., None]
    s = torch.where(pos >= 0, s + base, -torch.inf)
    return s.flatten(1), pos.flatten(1).to(torch.int32)


def _launch_scan(q, packed, scales, row_ids, lists, base, *, k, bits, group_size,
                 track_positions, code_mult, code_offset):
    """Pass 1 of K6 and all of K7 → (B, nprobe, k) best-first (score, id)."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import check, load_kernels

    B, D = q.shape
    C, L, W = packed.shape
    nprobe = lists.shape[1]
    dev = q.device
    for name, t in (("centroids/packed", packed), ("scales", scales), ("row_ids", row_ids), ("probes", lists)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, queries on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"K6/K7 run on a CUDA device, got {dev}")
    if packed.dtype != torch.int8 or scales.dtype != torch.bfloat16 or row_ids.dtype != torch.int32:
        raise ValueError("packed must be int8, scales bfloat16 and row_ids int32")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} is outside 1..{MAX_K}")
    if W % 4 or packed.data_ptr() % 4:
        raise ValueError(f"packed rows of {W} bytes are not whole, aligned 32-bit words")
    slots = 1 << (k + _TILE - 1).bit_length()
    if 4 * D + 8 * slots > _SMEM_LIMIT:
        raise ValueError(f"dim {D} with k = {k} needs more than {_SMEM_LIMIT} bytes of shared memory")
    if C * L >= 2**31:
        raise ValueError("storage positions must fit in int32")
    qb = q.to(torch.bfloat16).contiguous()
    packed, scales, row_ids = packed.contiguous(), scales.contiguous(), row_ids.contiguous()
    lists = lists.to(torch.int32).contiguous()
    out_s = torch.empty((B, nprobe, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, nprobe, k), dtype=torch.int32, device=dev)
    if B * nprobe == 0:
        return out_s, out_i
    status = load_kernels().itx_ivf_scan_lists(
        qb.data_ptr(), packed.data_ptr(), scales.data_ptr(), row_ids.data_ptr(),
        lists.data_ptr(), None if base is None else base.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), B, nprobe, D, L, D // group_size, group_size,
        bits, k, code_mult, code_offset, int(track_positions),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_ivf_scan_lists")
    return out_s, out_i


def ivf_scan_topk_cuda(q, centroids, packed, scales, row_ids, probes, *, k: int, bits: int,
                       group_size: int, l_blk: int, track_positions: bool = False,
                       code_mult: int = 1, code_offset: int = 0):
    """Launch K6 on CUDA tensors: one block per (query, distinct probed list)
    keeps that list's top-k, then one block per query merges them."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import check, load_kernels

    _check_storage(q, packed, scales, row_ids, probes, bits, group_size, l_blk)
    csims = q.to(torch.float32) @ centroids.to(torch.float32).T
    lists = _dedup_probes(probes)
    base = torch.gather(csims, 1, lists.clamp_min(0)).contiguous()
    s1, i1 = _launch_scan(q, packed, scales, row_ids, lists, base, k=k, bits=bits,
                          group_size=group_size, track_positions=track_positions,
                          code_mult=code_mult, code_offset=code_offset)
    B, R = s1.shape[0], s1.shape[1] * k
    out_s = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    if B and R:
        status = load_kernels().itx_ivf_merge_topk(
            s1.data_ptr(), i1.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B, R, k,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        check(status, "itx_ivf_merge_topk")
        ivf_scan_topk_cuda.launches += 1
    return out_s, out_i


ivf_scan_topk_cuda.launches = 0


def ivf_scan_candidates_cuda(q, centroids, packed, scales, row_ids, probes, *, t: int, bits: int,
                             group_size: int, l_blk: int, code_mult: int = 1, code_offset: int = 0):
    """Launch K7 on CUDA tensors: one block per (query, probe slot) keeps
    that list's top-t by the base-free score; the base is added here."""
    _check_storage(q, packed, scales, row_ids, probes, bits, group_size, l_blk)
    csims = q.to(torch.float32) @ centroids.to(torch.float32).T
    s, pos = _launch_scan(q, packed, scales, row_ids, probes, None, k=t, bits=bits,
                          group_size=group_size, track_positions=True,
                          code_mult=code_mult, code_offset=code_offset)
    if probes.numel():
        ivf_scan_candidates_cuda.launches += 1
    return _add_base(s, pos, csims, probes)


ivf_scan_candidates_cuda.launches = 0


def ivf_scan_topk(q, centroids, packed, scales, row_ids, probes, **kw):
    """→ (scores (B, k) f32, ids (B, k) int32): K6 on a CUDA tensor, its
    plain version on a CPU tensor. See the module docstring."""
    if q.device.type == "cpu":
        return ivf_scan_topk_plain(q, centroids, packed, scales, row_ids, probes, **kw)
    return ivf_scan_topk_cuda(q, centroids, packed, scales, row_ids, probes, **kw)


def ivf_scan_candidates(q, centroids, packed, scales, row_ids, probes, **kw):
    """→ (scores (B, nprobe·t) f32, positions (B, nprobe·t) int32): K7 on a
    CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return ivf_scan_candidates_plain(q, centroids, packed, scales, row_ids, probes, **kw)
    return ivf_scan_candidates_cuda(q, centroids, packed, scales, row_ids, probes, **kw)
