"""Small device-side k-means used by IVF coarse quantizers.

Port of `intel_extension_for_transformers_tpu/retrieval/_kmeans.py`. The
initial picks and the splits draw from `np.random.default_rng(seed)` as the
JAX package does, so both packages start from the same rows; the distance and
update steps are torch on the sample's device (f32; keep TF32 off on the
card). `torch.argmin`, like `jnp.argmin`, takes the first index on ties, and
`_top_k` keeps `lax.top_k`'s order (ties to the lowest index), so the same
distances give the same assignments.
"""

from __future__ import annotations

import numpy as np
import torch

_ONE_HOT_ELEMENTS = 1 << 25  # rows x clusters per one-hot block in `_update_centroids`


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` along the last dim: values descending, equal values by
    lowest index first (`torch.topk` promises no order among ties).

    `torch.topk` picks k + 1 candidates; the rows where the k-th and the
    (k+1)-th tie, and so the choice among equal values may reach past the
    candidates, take a full stable sort."""
    n = x.shape[-1]
    if k >= n:
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals, idx
    vals, idx = torch.topk(x, k + 1, dim=-1)
    idx, order = torch.sort(idx, dim=-1)  # index ascending, then a stable value sort
    vals = torch.gather(vals, -1, order)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    idx = torch.gather(idx, -1, order)
    tie = vals[..., k - 1] == vals[..., k]
    vals, idx = vals[..., :k].clone(), idx[..., :k].clone()
    if bool(tie.any()):
        full_v, full_i = torch.sort(x[tie], dim=-1, descending=True, stable=True)
        vals[tie], idx[tie] = full_v[:, :k], full_i[:, :k]
    return vals, idx


def _sq_dists(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(N, C) squared L2 distances, in the JAX package's order of operations."""
    return (
        torch.sum(x**2, dim=1, keepdim=True)
        - (2.0 * x) @ cent.T
        + torch.sum(cent**2, dim=1)[None, :]
    )


def _nearest_centroid(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """L2 assignment (balanced lists even for raw-IP data) → (N,) int64."""
    return torch.argmin(_sq_dists(x, cent), dim=1)


def _update_centroids(x: torch.Tensor, assign: torch.Tensor, C: int, prev: torch.Tensor):
    """Cluster means (`prev` where a cluster is empty). The sums are one-hot
    products taken a block of rows at a time: deterministic on the card,
    unlike `index_add_`'s atomics, and bounded in memory at any C."""
    n = x.shape[0]
    step = max(1, _ONE_HOT_ELEMENTS // max(C, 1))
    sums = torch.zeros((C, x.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(0, n, step):
        one_hot = torch.nn.functional.one_hot(assign[i : i + step], C).to(torch.float32)
        sums += one_hot.T @ x[i : i + step]
    counts = _cluster_counts(assign, C).to(torch.float32)[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1), prev)


def _cluster_counts(assign: torch.Tensor, C: int) -> torch.Tensor:
    return torch.bincount(assign, minlength=C)


def _rank_in_group(assign: torch.Tensor) -> torch.Tensor:
    """Rank of each row among rows with the same value (stable sort: rows of
    one value keep their order)."""
    n = assign.shape[0]
    order = torch.argsort(assign, stable=True)
    sorted_a = assign[order]
    idx = torch.arange(n, device=assign.device)
    new_run = torch.ones(n, dtype=torch.bool, device=assign.device)
    new_run[1:] = sorted_a[1:] != sorted_a[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    rank = torch.empty_like(assign)
    rank[order] = (idx - run_start).to(assign.dtype)
    return rank


def _assign_constrained(x, cent, cap: int, C: int, rounds: int = 4) -> torch.Tensor:
    """Capacity-constrained assignment: every point lands in one of its
    `rounds` nearest clusters if one has room, else in guaranteed free
    capacity (so counts <= cap always, no point dropped); same-cluster
    contention within a round is settled by rank in group."""
    n = x.shape[0]
    dev = x.device
    _, topk = _top_k(-_sq_dists(x, cent), rounds)  # (n, R)
    assign = torch.zeros(n, dtype=torch.int64, device=dev)
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    fill = torch.zeros(C, dtype=torch.int64, device=dev)
    for r in range(rounds):
        cand = topk[:, r]
        a = torch.where(placed, C, cand)  # C = sentinel for already placed
        sl = fill[a.clamp(0, C - 1)] + _rank_in_group(a)
        ok = ~placed & (sl < cap)
        assign = torch.where(ok, cand, assign)
        fill = fill + torch.bincount(torch.where(ok, cand, C), minlength=C + 1)[:C]
        placed = placed | ok
    # leftovers → global free capacity (cap·C >= n guarantees room): the j-th
    # leftover takes the j-th slot of the concatenated free-slot space
    free = torch.clamp(cap - fill, min=0)
    cum = torch.cumsum(free, dim=0)
    leftover_rank = torch.cumsum((~placed).to(torch.int64), dim=0) - 1
    fallback = torch.searchsorted(cum, leftover_rank, right=True)
    return torch.where(placed, assign, fallback.clamp(0, C - 1))


def kmeans(
    sample,
    n_clusters: int,
    iters: int = 10,
    seed: int = 0,
    normalize: bool = False,
    balance_rounds: int = 2,
    balance_ratio: float = 4.0,
    constrained: bool = False,
    cap_slack: float = 1.1,
) -> torch.Tensor:
    """→ (C, D) f32 centroids on the sample's device. Host loop, device
    distance and update steps.

    Balancing: IVF pays the longest list on every bounded probe, so after
    Lloyd's steps clusters larger than `balance_ratio` x the mean are split
    (two random members seed the halves, replacing the smallest clusters)
    and a few Lloyd steps re-run. `constrained=True` instead runs every step
    with the capacity-constrained assignment (cap = cap_slack·n/C)."""
    x = torch.as_tensor(sample).to(torch.float32)
    n = x.shape[0]
    C = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    cent = x[torch.as_tensor(rng.choice(n, C, replace=False), device=x.device)]
    cap = int(np.ceil(cap_slack * n / C)) if constrained else 0
    for _ in range(iters):
        assign = _assign_constrained(x, cent, cap, C) if constrained else _nearest_centroid(x, cent)
        cent = _update_centroids(x, assign, C, cent)
    if constrained:
        balance_rounds = 0  # capacity already enforced every step

    for _ in range(balance_rounds):
        assign = _nearest_centroid(x, cent)
        counts = _cluster_counts(assign, C).cpu().numpy()
        mean = max(1.0, n / C)
        big = np.where(counts > balance_ratio * mean)[0]
        if len(big) == 0:
            break
        small = np.argsort(counts)[: len(big)]
        cent_np = cent.cpu().numpy().copy()
        assign_np = assign.cpu().numpy()
        x_np = x.cpu().numpy()
        for b, sm in zip(big, small):
            # bisect: seed the two children from random members of the big
            # cluster (jittered-centroid splits re-collapse under Lloyd)
            members = np.where(assign_np == b)[0]
            picks = rng.choice(members, 2, replace=False)
            cent_np[b] = x_np[picks[0]]
            cent_np[sm] = x_np[picks[1]]
        cent = torch.from_numpy(cent_np).to(x.device)
        for _ in range(max(2, iters // 3)):
            assign = _nearest_centroid(x, cent)
            cent = _update_centroids(x, assign, C, cent)

    if normalize:
        cent = cent / torch.linalg.vector_norm(cent, dim=1, keepdim=True).clamp_min(1e-9)
    return cent


def kmeans_hierarchical(
    sample,
    n_clusters: int,
    l1: int = 0,
    iters: int = 8,
    l2_iters: int = 5,
    l2_balance_rounds: int = 0,
    l2_balance_ratio: float = 1.3,
    seed: int = 0,
    normalize: bool = False,
) -> torch.Tensor:
    """Two-level mass-proportional coarse quantizer: level-1 k-means finds
    `l1` regions, each region gets a level-2 centroid budget proportional to
    its member count (largest-remainder rounding, >= 1 per live region), and
    an independent k-means runs inside each region, so the mass per final
    list is ~n/C however lumpy the corpus is."""
    x = torch.as_tensor(sample).to(torch.float32)
    dev = x.device
    n = x.shape[0]
    C = min(n_clusters, n)
    l1 = l1 or max(1, C // 8)
    # with l1 > C every live region's floor budget of 1 already sums past C
    l1 = min(l1, C)
    cent1 = kmeans(x, l1, iters=iters, seed=seed)
    assign1 = _nearest_centroid(x, cent1).cpu().numpy()
    counts = np.bincount(assign1, minlength=l1)

    # largest-remainder mass-proportional budgets, every live region >= 1
    live = counts > 0
    raw = counts / max(1, counts.sum()) * C
    budget = np.maximum(np.floor(raw).astype(int), live.astype(int))
    rem = raw - np.floor(raw)
    order = np.argsort(-rem)
    i = 0
    while budget.sum() < C:
        b = order[i % l1]
        if live[b]:
            budget[b] += 1
        i += 1
    order_small = np.argsort(rem)
    i = 0
    while budget.sum() > C:
        b = order_small[i % l1]
        if live[b] and budget[b] > 1:
            budget[b] -= 1
        i += 1
        if i >= 2 * l1 * max(1, int(budget.sum() - C)):
            break  # every live budget at 1: nothing left to trim

    rng = np.random.default_rng(seed + 1)
    out = []
    for c in range(l1):
        if not live[c]:
            continue
        members = np.where(assign1 == c)[0]
        k = int(budget[c])
        if k == 1 or len(members) <= k:
            # degenerate: the region itself (or member points where the
            # budget exceeds one)
            if k <= 1:
                out.append(cent1[c][None, :])
            else:
                picks = rng.choice(members, min(k, len(members)), replace=False)
                out.append(x[torch.as_tensor(picks, device=dev)])
            continue
        sub = x[torch.as_tensor(members, device=dev)]
        out.append(kmeans(sub, k, iters=l2_iters, seed=seed + 2 + c,
                          balance_rounds=l2_balance_rounds, balance_ratio=l2_balance_ratio))
    cent = torch.cat(out, dim=0)
    if cent.shape[0] < C:  # dead-region budget shortfall → random fill
        extra = rng.choice(n, C - cent.shape[0], replace=False)
        cent = torch.cat([cent, x[torch.as_tensor(extra, device=dev)]], dim=0)
    if normalize:
        cent = cent / torch.linalg.vector_norm(cent, dim=1, keepdim=True).clamp_min(1e-9)
    return cent
