"""Fused similarity scan + per-tile top-2 (K5) for dense retrieval.

Port of `intel_extension_for_transformers_tpu/ops/scan_topk.py`. At large
query batches the (B, N) score matrix is what flat search pays for: writing
it and reading it back for top-k costs 8·B·N bytes. K5,
`csrc/scan_top2.cu`, never writes it: each doc tile of `n_tile` rows is
scored in shared memory and reduced to each query's top-2 (score, global
id) inside the kernel. A `torch.topk` over the tile winners then yields the
oversample candidate set (`scan_topk_candidates`).

Why top-2 per tile: one winner per tile loses a true top-10 member whenever
two land in the same tile; with two, only a three-way collision in one tile
loses one, which is rare enough that top-32-of-winners holds the true top-10.

Rules the kernel and its plain version share: scores are bf16 products with
f32 accumulation; columns >= size score −inf; on equal scores the highest id
wins; a tile with no valid column gives (−inf, −1).
"""

from __future__ import annotations

import torch

N_TILE = 1024
_PLAIN_CHUNK = 1024  # queries per materialized score block in the plain version


def _n_tiles(n: int, n_tile: int) -> int:
    return -(-n // n_tile)


def scan_top2_plain(
    queries: torch.Tensor, docs: torch.Tensor, size: int, n_tile: int = N_TILE
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain PyTorch version (materializes the scores, a block of
    queries at a time)."""
    B = queries.shape[0]
    N = docs.shape[0]
    T = _n_tiles(N, n_tile)
    Np = T * n_tile
    d = docs.to(torch.bfloat16).to(torch.float32)
    gcol = torch.arange(Np, device=docs.device, dtype=torch.int32).reshape(1, T, n_tile)
    neg = torch.tensor(-torch.inf, device=docs.device)
    vals, ids = [], []
    for b0 in range(0, B, _PLAIN_CHUNK):
        q = queries[b0 : b0 + _PLAIN_CHUNK].to(torch.bfloat16).to(torch.float32)
        s = torch.matmul(q, d.T)  # exact bf16 products, f32 sums
        s = torch.nn.functional.pad(s, (0, Np - N), value=-torch.inf)
        s = torch.where(gcol.reshape(1, Np) < size, s, neg).reshape(-1, T, n_tile)
        finite = s > -torch.inf
        m1 = s.amax(dim=2, keepdim=True)
        a1 = torch.where((s == m1) & finite, gcol, -1).amax(dim=2, keepdim=True)
        s2 = torch.where(gcol == a1, neg, s)
        m2 = s2.amax(dim=2, keepdim=True)
        a2 = torch.where((s2 == m2) & (s2 > -torch.inf), gcol, -1).amax(dim=2, keepdim=True)
        vals.append(torch.cat([m1, m2], dim=2).reshape(-1, 2 * T))
        ids.append(torch.cat([a1, a2], dim=2).reshape(-1, 2 * T))
    return torch.cat(vals), torch.cat(ids).to(torch.int32)


def scan_top2_cuda(
    queries: torch.Tensor, docs: torch.Tensor, size: int, n_tile: int = N_TILE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on CUDA tensors (cast to contiguous bf16 here)."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    dev = queries.device
    if dev.type != "cuda" or docs.device != dev:
        raise ValueError(f"K5 runs on one CUDA device, got {dev} and {docs.device}")
    B, D = queries.shape
    N = docs.shape[0]
    if docs.shape[1] != D:
        raise ValueError(f"queries have dim {D}, docs {docs.shape[1]}")
    q = queries.to(torch.bfloat16).contiguous()
    d = docs.to(torch.bfloat16).contiguous()
    T = _n_tiles(N, n_tile)
    vals = torch.empty((B, 2 * T), dtype=torch.float32, device=dev)
    ids = torch.empty((B, 2 * T), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return vals, ids
    status = load_kernels().itx_scan_top2(
        q.data_ptr(), d.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        B, N, D, int(size), n_tile, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_scan_top2")
    scan_top2_cuda.launches += 1
    return vals, ids


scan_top2_cuda.launches = 0


def scan_top2(
    queries: torch.Tensor, docs: torch.Tensor, size: int, *, n_tile: int = N_TILE
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (vals (B, 2T) f32, ids (B, 2T) int32), T = ceil(N / n_tile).

    Entries of a tile are (top1, top2); invalid rows carry −inf and id −1.
    A CUDA tensor launches K5; the plain version runs only for a CPU tensor.
    """
    if queries.device.type == "cpu":
        return scan_top2_plain(queries, docs, int(size), n_tile)
    return scan_top2_cuda(queries, docs, int(size), n_tile)


def scan_topk_candidates(
    queries: torch.Tensor, docs: torch.Tensor, size: int, m: int, **kw
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-scan oversampling → (scores (B, m), ids (B, m)): the top-m of the
    per-tile winners (exact scores; `torch.topk` orders ties differently from
    `lax.top_k`)."""
    vals, ids = scan_top2(queries, docs, size, **kw)
    m = min(m, vals.shape[1])
    best, pos = torch.topk(vals, m, dim=1)
    return best, torch.gather(ids, 1, pos)
