"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

Drives the port's retrieval path (intel_extension_for_transformers_tpu_torch)
at BGE-base width on random weights made from a seed, and checks each
hand-written kernel against its plain PyTorch version on the card:

  0. probe the card (sm_90), print its name and power limit, TF32 off;
  1. build the kernels from csrc/ with nvcc (sm_90a);
  2. K1 (int4 WOQ GEMM) and K5 (scan + per-tile top-2) against their plain
     versions at the path's shapes, with errors and CUDA-event times;
  3. the RAG path: INT4 BGE-base encoder → int4 flat index → INT4
     cross-encoder rerank → QA prompt, over docs/ and the repository's *.md;
  4. the flat-search workload of bench.py: 100k x 768 clustered embeddings in
     an int4 + bf16-shadow index; recall@10 at B = 256, QPS at B = 4096, and
     the two-tier int4 path at B = 16.

Each kernel wrapper counts its launches; the counts are zeroed before phase
3 and read after phase 4, and every kernel must have launched there. The
line before the last is a JSON object of the kernels' numbers; the last line
is {"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero without that line.

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "intel_extension_for_transformers_tpu_torch"
QUERIES = [
    "How are int4 weights packed into bytes?",
    "What does the cross-encoder reranker score?",
    "How is recall@10 measured for the flat index?",
    "Which kernels does the retrieval path run?",
    "How are documents split into chunks?",
    "What is the north star of this round of work?",
    "How does the serving engine batch requests?",
    "What does the bf16 shadow copy of the index buy?",
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of `fn` over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from intel_extension_for_transformers_tpu_torch.models.bert import (
        BertConfig,
        bert_init_params,
    )
    from intel_extension_for_transformers_tpu_torch.ops import kernels
    from intel_extension_for_transformers_tpu_torch.ops.packing import quantize_groupwise
    from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import (
        woq_int4_cuda,
        woq_matmul_plain,
    )
    from intel_extension_for_transformers_tpu_torch.ops.scan_topk import (
        scan_top2_cuda,
        scan_top2_plain,
    )
    from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig, quantize_model
    from intel_extension_for_transformers_tpu_torch.retrieval import (
        CrossEncoder,
        CrossEncoderReranker,
        FlatIndex,
        RetrievalAgent,
        TextEmbedder,
        clustered_embeddings,
        exact_topk,
        recall_at_k,
    )
    from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda

    # ---- phase 0: the card ----
    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    kernels.load_kernels()
    print(f"build: {kernels.library_path().name} in {time.perf_counter() - t0:.1f} s")

    # ---- phase 2: each kernel against its plain version ----
    def rel_err(got, want):
        return float(torch.linalg.vector_norm((got - want).float()) / torch.linalg.vector_norm(want.float()))

    k1_cases = []

    def k1_case(label, M, K, N, g, weight_dtype, scheme, x_dtype, out_dtype, scale_dtype):
        gen = torch.Generator(device=dev).manual_seed(7 * M + K + N)
        x = torch.randn(M, K, generator=gen, device=dev).to(x_dtype)
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        qt = quantize_groupwise(w, weight_dtype, scheme, g, scale_dtype=scale_dtype)
        got = woq_int4_cuda(x, qt, out_dtype)
        want = woq_matmul_plain(x, qt, out_dtype)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        mabs = float((got.float() - want.float()).abs().max())
        bar = 1e-5 if x_dtype == torch.float32 and out_dtype == torch.float32 else 2e-3
        ms = cuda_ms(torch, lambda: woq_int4_cuda(x, qt, out_dtype), 20)
        plain_ms = cuda_ms(torch, lambda: woq_matmul_plain(x, qt, out_dtype), 20)
        case = dict(label=label, M=M, K=K, N=N, g=g, weight=f"{weight_dtype}/{scheme}",
                    x=str(x_dtype)[6:], out=str(out_dtype)[6:], rel_err=rel, max_abs_err=mabs,
                    bar=bar, ms=ms, plain_ms=plain_ms)
        print("K1 " + json.dumps(case))
        check(rel <= bar and bool(torch.isfinite(got.float()).all()), f"K1 {label} rel {rel} > {bar}")
        k1_cases.append(case)

    f32, bf16 = torch.float32, torch.bfloat16
    for K, N, lbl in ((768, 768, "qkvo/pooler"), (768, 3072, "ffn_in"), (3072, 768, "ffn_out")):
        for M in (1, 64, 512):
            for dt in (f32, bf16):
                k1_case(f"bge {lbl}", M, K, N, 128, "int4", "sym", dt, dt, f32)
    k1_case("bge qkvo asym", 64, 768, 768, 128, "int4", "asym", f32, f32, f32)
    k1_case("bge qkvo nf4", 64, 768, 768, 128, "nf4", "sym", bf16, bf16, f32)
    k1_case("index scan", 16, 768, 100_000, 64, "int4", "sym", bf16, bf16, bf16)

    k5_cases = []

    def k5_case(B, N, D, size):
        gen = torch.Generator(device=dev).manual_seed(B + size)
        q = torch.nn.functional.normalize(torch.randn(B, D, generator=gen, device=dev), dim=1)
        d = torch.nn.functional.normalize(torch.randn(N, D, generator=gen, device=dev), dim=1)
        kv, ki = scan_top2_cuda(q, d, size)
        pv, pi = scan_top2_plain(q, d, size)
        torch.cuda.synchronize()
        finite = torch.isfinite(pv)
        check(bool((torch.isfinite(kv) == finite).all()), "K5 masked slots differ")
        mabs = float((kv[finite] - pv[finite]).abs().max())
        check(mabs <= 1e-4, f"K5 scores differ by {mabs}")
        check(int(ki.max()) < size and bool(((ki == -1) == ~finite).all()), "K5 ids out of range")
        # where ids differ, the two docs must score within 1e-4 of each other
        rows, cols = torch.nonzero(ki != pi, as_tuple=True)
        qb, db = q.to(bf16).float(), d.to(bf16).float()
        sk = (qb[rows] * db[ki[rows, cols].long()]).sum(1)
        sp = (qb[rows] * db[pi[rows, cols].long()]).sum(1)
        id_gap = float((sk - sp).abs().max()) if rows.numel() else 0.0
        check(id_gap <= 1e-4, f"K5 ids differ off a tie: {id_gap}")
        ms = cuda_ms(torch, lambda: scan_top2_cuda(q, d, size), 5, warmup=1)
        plain_ms = cuda_ms(torch, lambda: scan_top2_plain(q, d, size), 5, warmup=1)
        case = dict(B=B, N=N, D=D, size=size, max_abs_err=mabs, ids_differing=int(rows.numel()),
                    max_score_gap_where_ids_differ=id_gap, ms=ms, plain_ms=plain_ms)
        print("K5 " + json.dumps(case))
        k5_cases.append(case)

    k5_case(4096, 100_000, 768, 100_000)
    k5_case(4096, 100_000, 768, 70_000)
    torch.cuda.empty_cache()

    # ---- main path: counts from here to the end of phase 4 ----
    woq_int4_cuda.launches = 0
    scan_top2_cuda.launches = 0

    # ---- phase 3: the RAG path at BGE-base width ----
    cfg = BertConfig.bge_base()
    t0 = time.perf_counter()
    encoder = bert_init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    quantize_model(encoder, RtnConfig(weight_dtype="int4", group_size=128))
    cross = bert_init_params(torch.Generator(device=dev).manual_seed(1), cfg, model_cls=CrossEncoder)
    quantize_model(cross, RtnConfig(weight_dtype="int4", group_size=128))
    torch.cuda.synchronize()
    build_models_s = time.perf_counter() - t0
    embedder = TextEmbedder(encoder, cfg)
    reranker = CrossEncoderReranker(cross, cfg)
    agent = RetrievalAgent(embedder, index_dtype="int4", reranker=reranker, top_k=4, rerank_top_n=3)

    stages = {k: 0.0 for k in ("parse", "encode_docs", "encode_queries", "search", "rerank")}
    k1_by_stage = {"search": 0, "rerank": 0}
    phase = {"encode": "encode_docs"}
    reranked = []

    def timed(obj, name, stage_of):
        fn = getattr(obj, name)

        def wrapper(*args, **kw):
            stage = stage_of()
            n0 = woq_int4_cuda.launches
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages[stage] += time.perf_counter() - t
            if stage in k1_by_stage:
                k1_by_stage[stage] += woq_int4_cuda.launches - n0
            if name == "encode":
                check(out.shape[1] == cfg.hidden_size and bool(np.isfinite(out).all()),
                      "embeddings are finite (n, 768)")
            if name == "rerank":
                reranked.append((args[0], args[1], out))
            return out

        setattr(obj, name, wrapper)

    timed(agent.parser, "load", lambda: "parse")
    timed(embedder, "encode", lambda: phase["encode"])
    timed(reranker, "rerank", lambda: "rerank")
    t0 = time.perf_counter()
    agent.create(os.path.join(ROOT, "docs"))
    md_files = [p for p in sorted(glob.glob(os.path.join(ROOT, "*.md"))) if os.path.getsize(p)]
    for path in md_files:
        agent.append_localdb(path)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stages["index_add"] = build_s - stages["parse"] - stages["encode_docs"]
    timed(agent.index, "search", lambda: "search")
    phase["encode"] = "encode_queries"
    prompts = []
    t0 = time.perf_counter()
    for q in QUERIES:
        prompts.append(agent.pre_llm_inference_actions(q))
    query_s = time.perf_counter() - t0
    n_chunks = len(agent.docs)
    print(f"rag: {n_chunks} chunks from docs/ and {len(md_files)} *.md; models built in "
          f"{build_models_s:.1f} s; KB built in {build_s:.2f} s; {len(QUERIES)} queries in {query_s:.2f} s")
    print("rag stages (s): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    print(f"rag prompt lengths (chars): {[len(p) for p in prompts]}")
    print(f"rag K1 launches: {json.dumps(k1_by_stage)}")
    check(n_chunks > 50 and len(agent.index) == n_chunks, "every chunk indexed")
    check(all("### Context:" in p and p.endswith("### Response:") for p in prompts),
          "every query got a retrieval-augmented prompt")
    check(len(reranked) == len(QUERIES) and all(len(out) == 3 for _, _, out in reranked),
          "each query reranked to top 3")
    check(k1_by_stage["search"] > 0 and k1_by_stage["rerank"] > 0, "K1 ran in search and rerank")

    # ---- phase 4: bench.py's flat-search workload ----
    N, D, K, OVER = 100_000, 768, 10, 32
    t0 = time.perf_counter()
    docs, queries = clustered_embeddings(N, D, n_queries=256, noise_scale=0.8, seed=0)
    gen_s = time.perf_counter() - t0
    index = FlatIndex(D, "int4", rescore_dtype="bfloat16", capacity=N, group_size=64, device=dev)
    t0 = time.perf_counter()
    index.add(docs)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    oracle = exact_topk(docs, queries, K)
    k5_before = scan_top2_cuda.launches
    _, ids = index.search(queries, k=K, method="approx_rescore", oversample=OVER)
    recall = recall_at_k(ids, oracle)
    check(scan_top2_cuda.launches > k5_before, "B = 256 search ran K5")
    k1_before = woq_int4_cuda.launches
    _, ids16 = index.search(queries[:16], k=K, method="approx_rescore", oversample=OVER)
    recall16 = recall_at_k(ids16, oracle[:16])
    check(woq_int4_cuda.launches > k1_before, "B = 16 search ran K1")
    qb = torch.nn.functional.normalize(
        torch.randn(4096, D, generator=torch.Generator(device=dev).manual_seed(3), device=dev), dim=1
    )
    iters = 20
    ms = cuda_ms(torch, lambda: index.search(qb, k=K, method="approx_rescore", oversample=OVER), iters)
    qps = 4096 / (ms / 1e3)
    mem_vs_f32 = index.nbytes / (4 * D * N)
    print(f"search: recall@10 {recall:.4f} (B=256, K5), {recall16:.4f} (B=16, K1 two-tier); "
          f"{qps:.1f} QPS at B=4096 ({ms:.3f} ms/batch over {iters}); index {mem_vs_f32:.3f}x f32 bytes; "
          f"data {gen_s:.1f} s, add {add_s:.2f} s")
    check(recall >= 0.99, f"recall@10 {recall} >= 0.99")

    launches = {"woq_int4": woq_int4_cuda.launches, "scan_top2": scan_top2_cuda.launches}
    check(all(n > 0 for n in launches.values()), f"every kernel launched on the main path: {launches}")

    # the reranker's scores on the card against the plain path on the CPU
    query, hits, out = reranked[0]
    cpu_scores = CrossEncoderReranker(copy.deepcopy(cross).cpu(), cfg).score(
        query, [h["content"] for h in hits]
    )
    gpu_scores = {h["content"]: h["metadata"]["relevance_score"] for h in out}
    cpu_of = dict(zip((h["content"] for h in hits), cpu_scores.tolist()))
    gap = max(abs(gpu_scores[c] - cpu_of[c]) for c in gpu_scores)
    print(f"rerank card vs CPU plain path: max |score diff| {gap:.2e} over {len(gpu_scores)} hits")
    check(gap <= 1e-3, f"rerank scores agree with the CPU plain path ({gap})")

    k1_index = next(c for c in k1_cases if c["label"] == "index scan")
    k5_full = k5_cases[0]
    summary = {"kernels": [
        {"name": "woq_int4", "route": "cuda", "source": f"{PKG}/csrc/woq_int4.cu",
         "replaces": "intel_extension_for_transformers_tpu/ops/quant_matmul.py:87",
         "launches": launches["woq_int4"],
         "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
         "ms": k1_index["ms"], "plain_ms": k1_index["plain_ms"]},
        {"name": "scan_top2", "route": "cuda", "source": f"{PKG}/csrc/scan_top2.cu",
         "replaces": "intel_extension_for_transformers_tpu/ops/scan_topk.py:39",
         "launches": launches["scan_top2"],
         "max_abs_err": max(c["max_abs_err"] for c in k5_cases),
         "ms": k5_full["ms"], "plain_ms": k5_full["plain_ms"]},
    ]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
