"""Where the time goes in a batch-64 IVF search at 10M x 768, on one card.

Builds the JAX package's 10M product configuration (`benchmarks/
bench_ivf_10m.py`, BENCHMARKS.md "IVF at 10M") through the port's public
`IVFIndex`: N rows of `clustered_embeddings_device` (256 topics, seed 0,
drawn in 500k-row chunks), a hierarchical quantizer (512 level-1 regions,
6 iterations) trained on the first 200k rows, one list per ~1,220.7 rows
(8,192 at 10M), spill inserts under a cap of 1.2x the mean fill (which
pads to 1,536 rows), group-32 residual codes. Two indexes in turn, the
first freed before the second is built:

- int8: K6 at nprobe 8, k 10;
- int4 + int8 refine with a dense lo plane: K7 at nprobe 8, rescore_t 24,
  then K6 with rescore_r 64 (track_positions), each followed by the exact
  rescore.

Each search mode runs `IVFIndex.search` on 64 queries under
`torch.profiler`. Device time is the sum of the kernel rows of
`key_averages()` (an operator's row repeats its kernels' time and is left
out); busy / wall is the device's busy share. Prints one JSON line per
mode, with the card's name and power limit first. Then, for each mode at
nprobe 8, 16 and 32, recall@10 against the exact f32 top-10 oracle and
where the oracle's rows sit (dropped at insert, in an unprobed list, in a
probed one).

    python -m intel_extension_for_transformers_tpu_torch.utils.profile_ivf [--n 10000000]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from intel_extension_for_transformers_tpu_torch.retrieval import (
    IVFIndex,
    clustered_embeddings_device,
    recall_at_k,
)

DIM = 768
ROWS_PER_LIST = 10_000_000 / 8192
CAP_RATIO = 1.2
GROUP_SIZE = 32
TRAIN_ROWS = 200_000
TRAIN_ITERS = 6
LEVEL1 = 512
BATCH = 64
NPROBE_SWEEP = (8, 16, 32)
# (index kind, IVFIndex kwargs beyond the shared ones, search modes: name → search kwargs)
KINDS = {
    "int8": (dict(dtype="int8"), {"k6": dict(k=10, nprobe=8)}),
    "int4_refine": (dict(dtype="int4", refine="int8"),
                    {"k7_t24": dict(k=10, nprobe=8, rescore_t=24),
                     "k6_r64": dict(k=10, nprobe=8, rescore_r=64)}),
}
# kernel names of the port's hand-written kernels, as the profiler shows them
KERNELS = {"ivf_scan_lists": "scan (K6 pass 1 / K7)", "ivf_merge_topk": "K6 merge"}


def corpus(n: int, dev, n_queries: int = BATCH):
    """→ (docs (n, 768), queries (n_queries, 768)) on the card."""
    return clustered_embeddings_device(n, DIM, n_queries, n_topics=256, seed=0, device=dev)


def n_lists_for(n: int) -> int:
    return max(1, round(n / ROWS_PER_LIST))


def build(kind: str, docs: torch.Tensor) -> tuple[IVFIndex, dict]:
    """Train and fill one index of `KINDS` → (index, build record)."""
    n = docs.shape[0]
    n_lists = n_lists_for(n)
    extra = dict(KINDS[kind][0])
    if extra.get("refine"):
        extra["refine_capacity"] = n  # the dense lo plane
    idx = IVFIndex(DIM, n_lists, list_cap=math.ceil(CAP_RATIO * n / n_lists), group_size=GROUP_SIZE,
                   spill=True, device=docs.device, **extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.train(docs[: min(TRAIN_ROWS, n)], iters=TRAIN_ITERS, seed=0, hierarchical=LEVEL1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(0, n, 500_000):
        idx.add(docs[i : i + 500_000])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return idx, {"kind": kind, "n": n, "n_lists": idx.n_lists, "list_cap": idx._list_cap,
                 "train_s": t1 - t0, "add_s": t2 - t1, "memory_bytes": idx.memory_bytes(),
                 "dropped": idx.dropped}


def exact_top10(docs: torch.Tensor, queries: torch.Tensor, chunk: int = 500_000):
    """The exact f32 top-10 ids (numpy) of each query over all docs, a chunk at a time."""
    B = queries.shape[0]
    best_s = torch.full((B, 10), -float("inf"), device=docs.device)
    best_i = torch.full((B, 10), -1, dtype=torch.int64, device=docs.device)
    for i in range(0, docs.shape[0], chunk):
        part = docs[i : i + chunk]
        s, j = torch.topk(queries @ part.T, min(10, part.shape[0]), dim=1)
        best_s, sel = torch.topk(torch.cat([best_s, s], 1), 10, dim=1)
        best_i = torch.gather(torch.cat([best_i, j + i], 1), 1, sel)
    return best_i.cpu().numpy()


def oracle_placement(idx: IVFIndex, queries: torch.Tensor, oracle, nprobe: int) -> dict:
    """Where the exact top-10 rows sit: the share dropped at insert, the
    share stored in a list the query does not probe, and the share stored
    in a probed list ("reach": the most recall a scan of the probed lists
    can give)."""
    C, L = idx.n_lists, idx._list_cap
    rid = idx._row_ids
    stored = rid >= 0
    list_of = torch.full((idx.size,), -1, dtype=torch.int64, device=rid.device)
    list_of[rid[stored].long()] = torch.arange(C * L, device=rid.device)[stored] // L
    lists = list_of[torch.as_tensor(oracle, device=rid.device)]
    probes = torch.topk(queries @ idx.centroids.T, nprobe, dim=1).indices
    probed = (lists[..., None] == probes[:, None, :]).any(-1)
    n = lists.numel()
    return {"dropped": int((lists < 0).sum()) / n, "unprobed": int(((lists >= 0) & ~probed).sum()) / n,
            "reach": int(probed.sum()) / n}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_search(idx: IVFIndex, queries: torch.Tensor, name: str, kw: dict, reps: int = 5) -> dict:
    """One search mode under the profiler → per-batch wall, device busy
    time and share, and device time by kernel."""
    idx.search(queries, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        idx.search(queries, **kw)  # returns numpy: ends in the copy to the host
    ms_unprofiled = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            idx.search(queries, **kw)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in rows)
    by_kernel: dict[str, float] = {}
    for e in rows:
        tag = next((k for sub, k in KERNELS.items() if sub in e.key), "other")
        by_kernel[tag] = by_kernel.get(tag, 0.0) + _device_us(e) / 1e3 / reps
    top = sorted(rows, key=_device_us, reverse=True)[:8]
    rec = {
        "mode": name, **kw, "batch": queries.shape[0],
        "ms_per_batch_unprofiled": ms_unprofiled,
        "ms_per_batch_profiled": wall_us / 1e3 / reps,
        "device_busy_ms_per_batch": busy_us / 1e3 / reps,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches_per_batch": sum(e.count for e in rows) / reps,
        "device_ms_per_batch_by_kernel": by_kernel,
        "top": [(e.key[:60], _device_us(e) / 1e3 / reps, e.count // reps) for e in top],
    }
    print("search " + json.dumps(rec))
    return rec


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_ivf: no CUDA device", file=sys.stderr)
        return 1
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=10_000_000)
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    docs, queries = corpus(args.n, dev)
    oracle = exact_top10(docs, queries)
    for kind, (_, modes) in KINDS.items():
        idx, rec = build(kind, docs)
        print("build " + json.dumps(rec))
        for name, kw in modes.items():
            profile_search(idx, queries, name, kw)
            for nprobe in NPROBE_SWEEP:
                kw_n = {**kw, "nprobe": nprobe}
                print("recall " + json.dumps({
                    "mode": name, **kw_n,
                    "recall_at_10": recall_at_k(idx.search(queries, **kw_n)[1], oracle),
                    **oracle_placement(idx, queries, oracle, nprobe)}))
        del idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
