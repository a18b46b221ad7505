"""IVF (inverted-file) index: k-means coarse quantizer + bounded-probe scan.

Port of the single-device parts of `intel_extension_for_transformers_tpu/
retrieval/ivf.py` (the "IVF coarse-quantize + flat rescore" configuration of
BASELINE.json configs[3]):

- Rows are grouped by list into a `(n_lists · list_cap, ·)` padded table, so
  a probe reads whole lists of a fixed length.
- Inserts assign only the new rows (nearest centroid) and write them into
  free slots of their lists: slot = fill + the row's stable rank among the
  batch's rows of the same list, so the layout is the JAX package's, slot
  for slot. Without `spill` the lists grow (a re-layout) when one would
  overflow; with `spill` a row tries its 8 nearest lists in order and is
  dropped (counted in `dropped`) when all are full.
- Storage: f32/bf16 rows, or int8/int4 group-scaled residuals (row minus
  centroid) with bf16 scales; `refine="int8"` splits the int8 code into a
  hi-nibble plane, scanned as int4, and a lo plane read only to rescore the
  scan's candidates exactly (`refine_capacity` keeps the lo plane dense, by
  row id).
- Search on coded storage goes through K6/K7 (`ops/ivf_scan.py`) on the card;
  `use_kernel=False` takes the materializing route, which decodes the
  probed lists in torch a block of queries at a time. `use_kernel=None` is
  the kernel route on the card and the materializing route on the CPU (the
  JAX package's default off the TPU); `use_kernel=True` on the CPU runs the
  kernels' plain versions (the JAX package's interpret mode).

The JAX package replaces its buffers functionally (donated scatters); the
port writes the new rows into its tables in place with `index_put_`. Rows a
spill insert drops are masked out before that write: the JAX package aims
them out of bounds and relies on XLA dropping such updates, which torch
would refuse. `ShardedIVFIndex` is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.ops.ivf_scan import (
    choose_blocking,
    ivf_scan_candidates,
    ivf_scan_topk,
)
from intel_extension_for_transformers_tpu_torch.ops.ivf_scan import (
    decode_residual as _decode_residual,
)
from intel_extension_for_transformers_tpu_torch.retrieval._kmeans import (
    _nearest_centroid,
    _sq_dists,
    _top_k,
    kmeans,
    kmeans_hierarchical,
)
from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device

__all__ = ["IVFIndex"]

_SPILL_ROUNDS = 8
# Bytes the materializing coded search allocates per decoded candidate
# element (gathered codes, int32 nibbles, f32 and bf16 residuals, the f32
# copy for the product; max_memory_allocated read 15.1 on an H100 at 10M x
# 768, PERF.md), and the budget a block of queries may spend on them. The
# JAX package reads its budget, a TPU HBM figure, from ITX_IVF_SEARCH_BYTES;
# the port does not.
_DECODE_BYTES_PER_ELEMENT = 16
_SEARCH_TEMP_BUDGET = 4 * 1024**3


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.to(torch.float32), dim=-1, keepdim=True)
    return (x.to(torch.float32) / n.clamp_min(eps)).to(x.dtype)


def _train_centroids(x, n_lists, iters, seed, **kw):
    """The hierarchical quantizer when `hierarchical` is passed (its level-1
    count, or True for C // 8), else flat k-means."""
    h = kw.pop("hierarchical", 0)
    if h:
        l1 = 0 if h is True else int(h)
        return kmeans_hierarchical(x, n_lists, l1=l1, iters=iters, seed=seed,
                                   normalize=kw.get("normalize", False))
    return kmeans(x, n_lists, iters=iters, seed=seed, **kw)


def _segment_rank(assign: torch.Tensor) -> torch.Tensor:
    """Rank of each row among same-value rows (stable sort + first position)."""
    M = assign.shape[0]
    order = torch.argsort(assign, stable=True)
    sorted_a = assign[order]
    first_pos = torch.searchsorted(sorted_a, sorted_a, right=False)
    rank = torch.empty(M, dtype=torch.int64, device=assign.device)
    rank[order] = torch.arange(M, device=assign.device) - first_pos
    return rank


def _plan_insert(vectors, centroids, fill):
    """→ (assign (M,), slot (M,), new_fill (C,)): each row's nearest list and
    its slot there (the list's fill + the row's rank in this batch)."""
    C = centroids.shape[0]
    assign = _nearest_centroid(vectors, centroids)
    slot = fill[assign] + _segment_rank(assign)
    new_fill = fill + torch.bincount(assign, minlength=C).to(fill.dtype)
    return assign, slot, new_fill


def _plan_insert_capped(vectors, centroids, fill, cap: int):
    """Capacity-bounded assignment with an 8-candidate spill cascade: a row
    tries its nearest lists in order (ties to the lower list, as
    `lax.top_k`) and lands in the first with room; rows turned away by all
    are dropped. → (assign, slot, new_fill, dropped mask)."""
    M = vectors.shape[0]
    C = centroids.shape[0]
    dev = vectors.device
    _, topk = _top_k(-_sq_dists(vectors, centroids), min(_SPILL_ROUNDS, C))
    assign = torch.zeros(M, dtype=torch.int64, device=dev)
    slot = torch.zeros(M, dtype=torch.int64, device=dev)
    placed = torch.zeros(M, dtype=torch.bool, device=dev)
    fill_cur = fill
    for r in range(topk.shape[1]):
        cand = topk[:, r]
        a = torch.where(placed, C, cand)  # C = sentinel: row already placed
        sl = fill_cur[a.clamp(0, C - 1)] + _segment_rank(a)
        ok = ~placed & (sl < cap)
        assign = torch.where(ok, cand, assign)
        slot = torch.where(ok, sl, slot)
        fill_cur = fill_cur + torch.bincount(torch.where(ok, cand, C), minlength=C + 1)[:C].to(fill.dtype)
        placed = placed | ok
    return assign, slot, fill_cur, ~placed


# ---------------------- low-bit residual codecs ----------------------


def _pack_pairs(n: torch.Tensor) -> torch.Tensor:
    """(M, D) int nibbles → (M, D/2) int8: column 2w in the low nibble of
    byte w, column 2w+1 in the high one."""
    v = (n[:, 0::2] & 0xF) | ((n[:, 1::2] & 0xF) << 4)
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def _encode_residual(v, cent_rows, group_size: int, bits: int):
    """v, cent_rows (M, D) f32 → (codes int8 (M, D/2) | (M, D), scales (M, G)
    bf16): symmetric group-wise codes of the residual, with the f32 scale
    max|r| / qmax (stored rounded to bf16)."""
    M, D = v.shape
    G = D // group_size
    qmax = 7 if bits == 4 else 127
    r = (v.to(torch.float32) - cent_rows.to(torch.float32)).reshape(M, G, group_size)
    scale = torch.amax(torch.abs(r), dim=-1) / qmax
    q = torch.clamp(torch.round(r / torch.clamp_min(scale[..., None], 1e-12)), -qmax - 1, qmax)
    q = q.to(torch.int32).reshape(M, D)
    codes = _pack_pairs(q) if bits == 4 else q.to(torch.int8)
    return codes, scale.to(torch.bfloat16)


def _encode_residual_split(v, cent_rows, group_size: int):
    """→ (hi (M, D/2) int8, lo (M, D/2) int8, scales (M, G) bf16): the int8
    residual code q as two nibble planes, hi = q >> 4 (signed; scanned as
    a centered int4, (16·hi + 8)·s) and lo = q & 0xF (unsigned; read only
    to rescore), each packed like the int4 codec."""
    codes8, scales = _encode_residual(v, cent_rows, group_size, bits=8)
    q = codes8.to(torch.int32)
    return _pack_pairs(q >> 4), _pack_pairs(q & 0xF), scales


def _decode_split_exact(hi_packed, lo_packed, scales, group_size: int):
    """The exact int8 residual from the two planes, q = 16·hi + lo:
    bit-identical to `_decode_residual` of the int8 codes."""
    h = hi_packed.to(torch.int32)
    l = lo_packed.to(torch.int32)  # noqa: E741
    he = torch.where((h & 0xF) >= 8, (h & 0xF) - 16, h & 0xF)
    q_even = he * 16 + (l & 0xF)
    q_odd = (h >> 4) * 16 + ((l >> 4) & 0xF)
    q = torch.stack([q_even, q_odd], dim=-1).reshape(*h.shape[:-1], 2 * h.shape[-1])
    G = scales.shape[-1]
    r = q.reshape(*q.shape[:-1], G, q.shape[-1] // G).to(torch.float32)
    r = (r * scales.to(torch.float32)[..., None]).to(torch.bfloat16)
    return r.reshape(*q.shape)


# ------------------------------ search ------------------------------


def _bf16_dots(q, rows) -> torch.Tensor:
    """(B, D) queries · (B, M, D) bf16 rows → (B, M): bf16 products, f32 sums."""
    qb = q.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("bd,bmd->bm", qb, rows.to(torch.float32))


def _probe(q, cent, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (csims (B, C) f32, probes (B, nprobe)): the nearest lists by inner
    product, in `lax.top_k`'s order."""
    csims = q.to(torch.float32) @ cent.to(torch.float32).T
    return csims, _top_k(csims, nprobe)[1]


def _coded_chunk_body(q, cent, packed, scales, row_ids, *, k, nprobe, list_cap, group_size,
                      bits, code_mult=1, code_offset=0, return_pos=False):
    B, D = q.shape
    C = cent.shape[0]
    csims, probes = _probe(q, cent, nprobe)
    cand_ids = row_ids.reshape(C, list_cap)[probes].reshape(B, nprobe * list_cap)
    pk = packed.reshape(C, list_cap, -1)[probes].reshape(B, nprobe * list_cap, -1)
    sc = scales.reshape(C, list_cap, -1)[probes].reshape(B, nprobe * list_cap, -1)
    resid = _decode_residual(pk, sc, group_size, bits, code_mult, code_offset)
    sims = _bf16_dots(q, resid)
    base = torch.gather(csims, 1, probes)
    sims = sims + torch.repeat_interleave(base, list_cap, dim=1)
    sims = torch.where(cand_ids >= 0, sims, -torch.inf)
    best, sel = _top_k(sims, min(k, sims.shape[1]))
    if return_pos:
        # flat storage positions of the selected candidates: the refine tier
        # gathers rows by position
        cand_pos = (probes[:, :, None] * list_cap
                    + torch.arange(list_cap, device=q.device)[None, None, :]).reshape(B, -1)
        cand_pos = torch.where(cand_ids >= 0, cand_pos, -1)
        return best, torch.gather(cand_pos, 1, sel)
    return best, torch.gather(cand_ids, 1, sel)


def _auto_query_chunk(B, nprobe, list_cap, D) -> int:
    """Queries per block of the materializing coded search (0: the whole batch)."""
    per_query = _DECODE_BYTES_PER_ELEMENT * nprobe * list_cap * D
    qc = max(1, _SEARCH_TEMP_BUDGET // max(per_query, 1))
    return 0 if qc >= B else qc


def _ivf_search_coded(q, cent, packed, scales, row_ids, *, k, nprobe, list_cap, group_size, bits,
                      query_chunk=0, code_mult=1, code_offset=0, return_pos=False):
    """Bounded-probe search over residual-coded storage, materializing the
    probed candidates' decode: score = q·centroid + q·residual.
    `query_chunk` > 0 bounds the decode temporaries to that many queries."""
    kw = dict(k=k, nprobe=nprobe, list_cap=list_cap, group_size=group_size, bits=bits,
              code_mult=code_mult, code_offset=code_offset, return_pos=return_pos)
    B = q.shape[0]
    if query_chunk <= 0 or query_chunk >= B:
        return _coded_chunk_body(q, cent, packed, scales, row_ids, **kw)
    parts = [_coded_chunk_body(q[i : i + query_chunk], cent, packed, scales, row_ids, **kw)
             for i in range(0, B, query_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _rescore_refine(q, cent, hi, lo, scales, row_ids, pos, *, k, group_size, list_cap,
                    lo_dense=False):
    """Second tier: gather the candidates' rows from both nibble planes,
    rebuild the exact int8 residual and re-rank (the int8 codec's scores).
    `lo_dense`: the lo plane is indexed by row id, not storage position."""
    csims = q.to(torch.float32) @ cent.to(torch.float32).T
    B, R = pos.shape
    safe = pos.to(torch.int64).clamp(0, hi.shape[0] - 1)
    ids = row_ids[safe]
    lo_rows = lo[ids.to(torch.int64).clamp(0, lo.shape[0] - 1)] if lo_dense else lo[safe]
    resid = _decode_split_exact(hi[safe], lo_rows, scales[safe], group_size)
    s = _bf16_dots(q, resid) + torch.gather(csims, 1, safe // list_cap)
    s = torch.where((pos >= 0) & (ids >= 0), s, -torch.inf)
    best, sel = _top_k(s, min(k, R))
    out_ids = torch.gather(ids, 1, sel)
    return best, torch.where(best > -torch.inf, out_ids, -1)


def _ivf_search(q, cent, storage, row_ids, *, k, nprobe, list_cap):
    """Bounded-probe search over list-grouped float storage (C·L, D)."""
    B, D = q.shape
    C = cent.shape[0]
    _, probes = _probe(q, cent, nprobe)
    cand_ids = row_ids.reshape(C, list_cap)[probes].reshape(B, nprobe * list_cap)
    vecs = storage.reshape(C, list_cap, D)[probes].reshape(B, nprobe * list_cap, D)
    qv = q.to(vecs.dtype).to(torch.float32)  # bf16 storage: bf16 products, f32 sums
    sims = torch.einsum("bd,bmd->bm", qv, vecs.to(torch.float32))
    sims = torch.where(cand_ids >= 0, sims, -torch.inf)
    best, sel = _top_k(sims, min(k, sims.shape[1]))
    return best, torch.gather(cand_ids, 1, sel)


class IVFIndex:
    """Single-device IVF index (see the module docstring); on the card
    unless `device` names another."""

    def __init__(
        self,
        dim: int,
        n_lists: int = 64,
        metric: str = "ip",
        dtype: str = "bfloat16",
        list_cap: int = 64,
        group_size: int = 32,  # coded dtypes: residual scale granularity
        spill: bool = False,  # hard-cap lists; overflow → next-nearest lists
        refine: Optional[str] = None,  # "int8": two-tier nibble-split store
        refine_capacity: Optional[int] = None,  # dense lo plane of this many rows
        *,
        device=None,
    ):
        if metric not in ("ip", "cosine"):
            raise ValueError(f"unsupported metric {metric}")
        if dtype not in ("float32", "bfloat16", "int8", "int4"):
            raise ValueError("IVF storage supports float32/bfloat16/int8/int4")
        if dtype in ("int4", "int8") and (dim % max(group_size, 2) or group_size % 2):
            raise ValueError("coded dtypes need even group_size dividing dim")
        if refine is not None and (refine != "int8" or dtype != "int4"):
            raise ValueError(
                "refine='int8' requires dtype='int4' (int4 scan tier + exact-int8 rescore tier)"
            )
        if refine_capacity is not None and refine is None:
            raise ValueError("refine_capacity requires refine='int8'")
        self.dim = dim
        self.n_lists = n_lists
        self.metric = metric
        self.dtype = dtype
        self.refine = refine
        self.refine_capacity = refine_capacity
        self._lo_dense = refine_capacity is not None
        self.group_size = group_size
        self.size = 0
        self.spill = bool(spill)
        self.dropped = 0  # spill mode: rows whose candidate lists were all full
        self.device = resolve_device(device)
        self.centroids: Optional[torch.Tensor] = None  # (C, D) f32
        self._list_cap = max(8, list_cap)
        self._l_blk: Optional[int] = None  # kernel blocking (coded)
        self._storage: Optional[torch.Tensor] = None  # (C·L, D) | int4 (C·L, D/2) | int8 (C·L, D)
        self._lo: Optional[torch.Tensor] = None  # refine: (C·L | capacity, D/2) lo nibbles
        self._scales: Optional[torch.Tensor] = None  # coded: (C·L, D/g) bf16
        self._row_ids: Optional[torch.Tensor] = None  # (C·L,) int32, -1 = empty
        self._fill: Optional[torch.Tensor] = None  # (C,) int32

    @property
    def _bits(self) -> int:
        return 4 if self.dtype == "int4" else 8

    def memory_bytes(self) -> int:
        """Row-payload bytes (storage + lo plane + scales + ids + centroids)."""
        return sum(a.numel() * a.element_size()
                   for a in (self._storage, self._lo, self._scales, self._row_ids, self.centroids)
                   if a is not None)

    def __len__(self) -> int:
        return self.size

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(device=self.device, dtype=torch.float32)

    @torch.inference_mode()
    def train(self, sample, iters: int = 10, seed: int = 0, **kmeans_kw) -> None:
        """k-means coarse quantizer on a representative sample. Extra kwargs
        reach `kmeans` (`hierarchical=l1` picks the two-level quantizer)."""
        x = self._to_device(sample)
        if self.metric == "cosine":
            x = _l2_normalize(x)
        self.centroids = _train_centroids(x, self.n_lists, iters, seed, **kmeans_kw)
        self.n_lists = self.centroids.shape[0]
        self._alloc(self._list_cap)

    def _alloc(self, L: int) -> None:
        C, dev = self.n_lists, self.device
        if self.dtype in ("int4", "int8"):
            # the cap rounds up to the kernel blocking, as in the JAX package
            self._l_blk, L = choose_blocking(L)
            W = self.dim // 2 if self.dtype == "int4" else self.dim
            self._storage = torch.zeros((C * L, W), dtype=torch.int8, device=dev)
            if self.refine:
                rows = self.refine_capacity if self._lo_dense else C * L
                self._lo = torch.zeros((rows, W), dtype=torch.int8, device=dev)
            self._scales = torch.zeros((C * L, self.dim // self.group_size), dtype=torch.bfloat16,
                                       device=dev)
        else:
            self._storage = torch.zeros((C * L, self.dim), dtype=getattr(torch, self.dtype), device=dev)
        self._row_ids = torch.full((C * L,), -1, dtype=torch.int32, device=dev)
        self._fill = torch.zeros(C, dtype=torch.int32, device=dev)
        self._list_cap = L

    def _grow_lists(self, new_cap: int) -> None:
        """Re-layout (C, L, ·) → (C, L', ·): each list gains empty slots."""
        C, L = self.n_lists, self._list_cap
        pad = new_cap - L

        def grow(a, fill_value=0):
            rest = a.shape[1:]
            al = a.reshape(C, L, *rest)
            extra = torch.full((C, pad, *rest), fill_value, dtype=a.dtype, device=a.device)
            return torch.cat([al, extra], dim=1).reshape(C * new_cap, *rest)

        self._storage = grow(self._storage)
        if self._lo is not None and not self._lo_dense:
            self._lo = grow(self._lo)
        if self._scales is not None:
            self._scales = grow(self._scales)
        self._row_ids = grow(self._row_ids, -1)
        self._list_cap = new_cap

    def _ensure_kernel_layout(self) -> None:
        """Pad the list cap to the kernel blocking (a no-op unless the lists
        grew, or the index was loaded from a save that predates it)."""
        l_blk, l_pad = choose_blocking(self._list_cap)
        self._l_blk = l_blk
        if l_pad != self._list_cap:
            self._grow_lists(l_pad)

    def add(self, vectors) -> np.ndarray:
        """Insert rows → their ids. Sub-batches keep the (M, C) distance
        matrix of one assignment near 1 GB."""
        if self.centroids is None:
            raise ValueError("IVFIndex.train must be called before add")
        v = self._to_device(vectors)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected (M, {self.dim}) vectors, got {tuple(v.shape)}")
        m_slice = max(1024, int(256e6 // max(1, self.n_lists)))
        if v.shape[0] > m_slice:
            return np.concatenate([self._add_batch(v[i : i + m_slice])
                                   for i in range(0, v.shape[0], m_slice)])
        return self._add_batch(v)

    @torch.inference_mode()
    def _add_batch(self, v) -> np.ndarray:
        if self.metric == "cosine":
            v = _l2_normalize(v)
        M = v.shape[0]
        ids = np.arange(self.size, self.size + M)
        if self.refine and self._lo_dense and self.size + M > self.refine_capacity:
            raise ValueError(f"dense refine plane full: capacity {self.refine_capacity}, "
                             f"adding {M} at size {self.size}")
        if self.spill:
            # bounded memory: never grow; rows that find no room are dropped
            assign, slot, new_fill, dropped = _plan_insert_capped(v, self.centroids, self._fill,
                                                                  self._list_cap)
            keep = ~dropped
            self.dropped += int(dropped.sum())  # one readback per add
        else:
            assign, slot, new_fill = _plan_insert(v, self.centroids, self._fill)
            max_fill = int(new_fill.max())  # one readback per add
            if max_fill > self._list_cap:
                # grow to need + 25% headroom, not doubling
                self._grow_lists(max(int(max_fill * 1.25), self._list_cap + 8))
            keep = None
        flat_pos = assign * self._list_cap + slot
        ids_dev = torch.arange(self.size, self.size + M, dtype=torch.int32, device=self.device)

        def put(table, pos, rows, mask=keep):
            if mask is not None:
                pos, rows = pos[mask], rows[mask]
            table.index_put_((pos,), rows)

        if self.refine:
            hi, lo, scales = _encode_residual_split(v, self.centroids[assign], self.group_size)
            put(self._storage, flat_pos, hi)
            # the dense lo plane is indexed by row id, dropped rows included
            # (their lo nibbles against list 0), as in the JAX package
            if self._lo_dense:
                put(self._lo, ids_dev.to(torch.int64), lo, None)
            else:
                put(self._lo, flat_pos, lo)
            put(self._scales, flat_pos, scales)
        elif self.dtype in ("int4", "int8"):
            packed, scales = _encode_residual(v, self.centroids[assign], self.group_size, self._bits)
            put(self._storage, flat_pos, packed)
            put(self._scales, flat_pos, scales)
        else:
            put(self._storage, flat_pos, v.to(self._storage.dtype))
        put(self._row_ids, flat_pos, ids_dev)
        self._fill = new_fill
        self.size += M
        return ids

    def _kernel_args(self):
        self._ensure_kernel_layout()
        C, L = self.n_lists, self._list_cap
        return (self._storage.reshape(C, L, -1), self._scales.reshape(C, L, -1),
                self._row_ids.reshape(C, L))

    @torch.inference_mode()
    def search(self, queries, k: int = 10, nprobe: int = 8, use_kernel: Optional[bool] = None,
               rescore_t: int = 16, rescore_r: Optional[int] = None):
        """Bounded-probe top-k → (scores (B, k) f32, ids (B, k) int32) as numpy.

        Coded dtypes take K6 (`ivf_scan_topk`) on the kernel route and the
        materializing decode otherwise (see the module docstring for
        `use_kernel`). refine='int8' indexes run two tiers: the hi-nibble
        scan selects candidates, then `_rescore_refine` re-ranks them with
        the exact int8 residual. Candidates: `rescore_r` set → the global
        top-r by hi-nibble score over the probed lists (K6 with
        `track_positions`); otherwise each probed list's top `rescore_t`
        (K7). The materializing route always keeps the global top
        nprobe·rescore_t."""
        if self.size == 0:
            raise ValueError("index is empty")
        q = self._to_device(queries)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        if self.metric == "cosine":
            q = _l2_normalize(q)
        nprobe = min(nprobe, self.n_lists)
        k = min(k, self.size)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        coded = dict(group_size=self.group_size)
        if self.refine:
            t = max(1, min(rescore_t, self._list_cap))
            hi_plane = dict(bits=4, code_mult=16, code_offset=8, **coded)
            if use_kernel:
                packed, scales, row_ids = self._kernel_args()
                _, probes = _probe(q, self.centroids, nprobe)
                args = (q, self.centroids, packed, scales, row_ids, probes)
                if rescore_r is not None:
                    _, pos = ivf_scan_topk(*args, k=max(k, rescore_r), l_blk=self._l_blk,
                                           track_positions=True, **hi_plane)
                else:
                    _, pos = ivf_scan_candidates(*args, t=t, l_blk=self._l_blk, **hi_plane)
            else:
                _, pos = _ivf_search_coded(
                    q, self.centroids, self._storage, self._scales, self._row_ids,
                    k=nprobe * t, nprobe=nprobe, list_cap=self._list_cap, return_pos=True,
                    query_chunk=_auto_query_chunk(q.shape[0], nprobe, self._list_cap, self.dim),
                    **hi_plane,
                )
            scores, ids = _rescore_refine(
                q, self.centroids, self._storage, self._lo, self._scales, self._row_ids, pos,
                k=k, group_size=self.group_size, list_cap=self._list_cap, lo_dense=self._lo_dense,
            )
        elif self.dtype in ("int4", "int8"):
            if use_kernel:
                packed, scales, row_ids = self._kernel_args()
                _, probes = _probe(q, self.centroids, nprobe)
                scores, ids = ivf_scan_topk(q, self.centroids, packed, scales, row_ids, probes, k=k,
                                            bits=self._bits, l_blk=self._l_blk, **coded)
            else:
                scores, ids = _ivf_search_coded(
                    q, self.centroids, self._storage, self._scales, self._row_ids, k=k,
                    nprobe=nprobe, list_cap=self._list_cap, bits=self._bits,
                    query_chunk=_auto_query_chunk(q.shape[0], nprobe, self._list_cap, self.dim),
                    **coded,
                )
        else:
            scores, ids = _ivf_search(q, self.centroids, self._storage, self._row_ids, k=k,
                                      nprobe=nprobe, list_cap=self._list_cap)
        scores = scores.to(torch.float32).cpu().numpy()
        ids = ids.to(torch.int32).cpu().numpy()
        if squeeze:
            return scores[0], ids[0]
        return scores, ids

    # ----------------------------- persistence -----------------------------

    def state(self) -> tuple[dict, dict]:
        """→ (meta, arrays): `ivf.json`'s fields and `ivf.npz`'s arrays, in
        the JAX package's format (bf16 storage and scales as f32)."""
        def f32(t):
            return t.to(torch.float32).cpu().numpy()

        arrays = {
            "centroids": f32(self.centroids),
            "storage": f32(self._storage) if self._storage.dtype == torch.bfloat16
            else self._storage.cpu().numpy(),
            "row_ids": self._row_ids.cpu().numpy(),
            "fill": self._fill.cpu().numpy(),
        }
        if self._scales is not None:
            arrays["scales"] = f32(self._scales)
        if self._lo is not None:
            arrays["lo"] = self._lo.cpu().numpy()
        meta = {
            "dim": self.dim, "n_lists": self.n_lists, "metric": self.metric, "dtype": self.dtype,
            "list_cap": self._list_cap, "size": self.size, "group_size": self.group_size,
            "refine": self.refine, "refine_capacity": self.refine_capacity,
        }
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device=None) -> "IVFIndex":
        """An index from `state()`'s output or the JAX package's `save()`
        payload (`ivf.json` fields, `ivf.npz` arrays as numpy)."""
        idx = cls(
            meta["dim"], meta["n_lists"], meta["metric"], meta["dtype"],
            list_cap=meta["list_cap"], group_size=meta.get("group_size", 32),
            refine=meta.get("refine"), refine_capacity=meta.get("refine_capacity"),
            device=device,
        )

        def put(name, dtype):
            return torch.from_numpy(np.array(arrays[name])).to(device=idx.device, dtype=dtype)

        coded = meta["dtype"] in ("int4", "int8")
        idx.centroids = put("centroids", torch.float32)
        idx._storage = put("storage", torch.int8 if coded else getattr(torch, meta["dtype"]))
        if "scales" in arrays:
            idx._scales = put("scales", torch.bfloat16)
        if "lo" in arrays:
            idx._lo = put("lo", torch.int8)
        idx._row_ids = put("row_ids", torch.int32)
        idx._fill = put("fill", torch.int32)
        idx.size = meta["size"]
        return idx

    def save(self, path: str) -> None:
        """Write ivf.npz + ivf.json (the JAX package loads them too)."""
        os.makedirs(path, exist_ok=True)
        meta, arrays = self.state()
        np.savez(os.path.join(path, "ivf.npz"), **arrays)
        with open(os.path.join(path, "ivf.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, *, device=None) -> "IVFIndex":
        """Load a directory saved by either package."""
        with open(os.path.join(path, "ivf.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "ivf.npz")) as npz:
            arrays = {key: npz[key] for key in npz.files}
        return cls.from_state(meta, arrays, device)
