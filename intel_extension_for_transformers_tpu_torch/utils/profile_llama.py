"""Where the time goes in INT4 and INT8 Llama-2-7B decode and scoring, on one card.

Builds `LlamaConfig.llama2_7b()` from random bf16 weights (seed 11),
quantizes it to int4 (RTN, sym, g = 128) and runs under `torch.profiler`:

1. the prefill of a 340-token prompt (time to the first token, then
   profiled) and 8 greedy decode steps of `generate_stream` after it, on
   the khalf model (K1), then again after `prepare_for_inference` (K3);
2. one 2048-token scoring window of `evaluate_perplexity` on the w32 model
   (K4 in every layer, K3 in every product);
3. the same decode on the model built again and quantized to int8 as
   `load_in_8bit` resolves it (RTN, sym, g = 128: K2);
4. K1, K3 and K2 alone at M = 1 on the decode products with a cold L2,
   eager and replayed from a CUDA graph (the device time alone), and the
   column-a-lane w32 GEMV that K3's split-K GEMV replaced beside them.

Device time is the sum of the kernel rows of `key_averages()` (the rows
whose device type is CUDA; an operator's row repeats its kernels' time and
is left out). One stream runs everything, so kernels never overlap and
busy / wall is the device's busy share. Prints one JSON line per
measurement, with the card's name and power limit first.

    python -m intel_extension_for_transformers_tpu_torch.utils.profile_llama
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from intel_extension_for_transformers_tpu_torch.evaluation import evaluate_perplexity
from intel_extension_for_transformers_tpu_torch.models.generation import (
    SamplingConfig,
    generate_stream,
)
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, llama_init_params
from intel_extension_for_transformers_tpu_torch.ops.packing import (
    prepare_for_inference,
    quantize_groupwise,
    to_decode_layout,
)
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import (
    woq_int4_cuda,
    woq_int8_cuda,
    woq_w32_cuda,
)
from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig, quantize_model

DECODE_STEPS = 8
PROMPT_TOKENS = 340
WINDOW = 2048
# the kernel names of the port's hand-written kernels, as the profiler shows them
# (K1: its SIMT tiles, its GEMV and its tensor-core tiles, tile_kernel<Int4Tile>;
# K2: its GEMV, SIMT tiles and tile_kernel<Int8Tile>; K3: its split-K GEMV
# woq_w32_gemv, told apart as "K3 gemv", then its SIMT tiles woq_w32_tiled and
# tile_kernel<W32Tile>; K4: bf16 on the tensor cores, f32 SIMT); the first match wins
KERNELS = {"woq_int4_kernel": "K1", "woq_int4_gemv": "K1", "Int4Tile": "K1", "woq_int8": "K2", "Int8Tile": "K2",
           "woq_w32_gemv": "K3 gemv", "woq_w32": "K3", "W32Tile": "K3", "flash_tc_kernel": "K4",
           "flash_kernel": "K4"}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profiled(fn) -> dict:
    """Run fn under the profiler → wall time, device busy time and kernel
    launches, with device time by kernel (K1-K4 by name, the rest together)
    and the top kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in rows)
    by_kernel: dict[str, float] = {}
    for e in rows:
        tag = next((k for sub, k in KERNELS.items() if sub in e.key), "other")
        by_kernel[tag] = by_kernel.get(tag, 0.0) + _device_us(e) / 1e3
    top = sorted(rows, key=_device_us, reverse=True)[:10]
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches": sum(e.count for e in rows),
        "device_ms_by_kernel": by_kernel,
        "top": [(e.key[:60], _device_us(e) / 1e3, e.count) for e in top],
    }


def profile_decode(model, config, ids, layout: str) -> None:
    """The prefill of `ids` (time to the first token, unprofiled, then
    profiled), then decode steps."""
    sampling = SamplingConfig(max_new_tokens=4 + 2 * DECODE_STEPS + 1)
    next(generate_stream(model, config, ids, sampling))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    next(generate_stream(model, config, ids, sampling))  # ends in the first token's copy to the host
    ttft_ms = (time.perf_counter() - t0) * 1e3
    rec = profiled(lambda: next(generate_stream(model, config, ids, sampling)))
    print(f"prefill {layout} " + json.dumps({"prompt_tokens": int(np.asarray(ids).size), "ttft_ms_unprofiled": ttft_ms,
                                             **{k: rec[k] for k in ("wall_ms", "device_busy_ms", "device_busy_share",
                                                                    "device_ms_by_kernel", "top")}}))
    it = generate_stream(model, config, ids, sampling)
    for _ in range(4):  # prefill and warm-up steps
        next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        next(it)  # each step ends in the token's copy to the host
    ms_unprofiled = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    rec = profiled(lambda: [next(it) for _ in range(DECODE_STEPS)])
    print(f"decode {layout} " + json.dumps({
        "ms_per_token_unprofiled": ms_unprofiled,
        "ms_per_token_profiled": rec["wall_ms"] / DECODE_STEPS,
        "device_busy_ms_per_token": rec["device_busy_ms"] / DECODE_STEPS,
        "device_busy_share": rec["device_busy_share"],
        "kernel_launches_per_token": rec["kernel_launches"] / DECODE_STEPS,
        "device_ms_per_token_by_kernel": {k: v / DECODE_STEPS for k, v in rec["device_ms_by_kernel"].items()},
        "top": rec["top"],
    }))


def profile_scoring(model, config, ids) -> None:
    evaluate_perplexity(model, config, ids, window=WINDOW, stride=WINDOW, batch_size=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_perplexity(model, config, ids, window=WINDOW, stride=WINDOW, batch_size=1)
    torch.cuda.synchronize()
    ms_unprofiled = (time.perf_counter() - t0) * 1e3
    rec = profiled(lambda: evaluate_perplexity(model, config, ids, window=WINDOW, stride=WINDOW,
                                               batch_size=1))
    print("scoring window " + json.dumps({"tokens": len(ids), "ms_unprofiled": ms_unprofiled, **rec}))


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of `fn` over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, x, weights, out_dtype=torch.bfloat16, calls: int = 80) -> tuple[float, float]:
    """→ (graph ms, eager ms) a call of fn(x, w, out_dtype), over `calls`
    calls cycling through `weights` (more bytes than the L2 holds), as a
    decode step meets its products. The graph time replays the calls from a
    CUDA graph: the device time alone. The eager time includes the host's
    cost a call where it exceeds the kernel's."""
    def run():
        for i in range(calls):
            fn(x, weights[i % len(weights)], out_dtype)

    eager = events_ms(run, 1, warmup=1) / calls
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # on the capturing stream first: K1 keeps its strip counters a stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        run()
    return events_ms(graph.replay, 3, warmup=1) / calls, eager


def cold_gemv(dev) -> None:
    """K1 (khalf), K3 (w32) and K2 (int8) at M = 1 on the Llama-2-7B
    products, by `cold_ms` over 8 copies of the weight (>= 67 MB, more than
    the 50 MB L2), with the column-a-lane w32 GEMV that K3's split-K GEMV
    replaced beside them ("k3_colwise", a yardstick). GB/s counts the
    packed weight's bytes over the graph time: K*N/2 for int4, K*N for
    int8."""
    from intel_extension_for_transformers_tpu_torch.utils.profile_woq_tiles import w32_gemv_colwise

    x = torch.randn(1, 11008, device=dev).to(torch.bfloat16)
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w = torch.randn(K, N, device=dev) * 0.02
        qts = [quantize_groupwise(w.roll(i, 0), "int4", "sym", 128) for i in range(8)]
        q8s = [quantize_groupwise(w.roll(i, 0), "int8", "sym", 128) for i in range(8)]
        del w
        row = {"K": K, "N": N, "words_MB": K * N / 2 / 1e6}
        xk = x[:, :K].contiguous()
        w32s = [to_decode_layout(q) for q in qts]
        for name, fn, ws in (("k1", woq_int4_cuda, qts), ("k3", woq_w32_cuda, w32s),
                             ("k3_colwise", w32_gemv_colwise, w32s), ("k2", woq_int8_cuda, q8s)):
            ms, row[name + "_cold_ms"] = cold_ms(fn, xk, ws)
            row[name + "_graph_ms"] = ms
            row[name + "_GBps"] = K * N / (1 if name == "k2" else 2) / (ms * 1e-3) / 1e9
        print("cold gemv " + json.dumps(row))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_llama: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b()
    model = llama_init_params(torch.Generator(device=dev).manual_seed(11), cfg, dtype=torch.bfloat16)
    quantize_model(model, RtnConfig(weight_dtype="int4", group_size=128))
    byte_ids = torch.randint(0, 256, (WINDOW,), generator=torch.Generator().manual_seed(0)).tolist()
    prompt = torch.tensor([byte_ids[:PROMPT_TOKENS]]).numpy()
    profile_decode(model, cfg, prompt, "khalf")
    prepare_for_inference(model)
    profile_decode(model, cfg, prompt, "w32")
    profile_scoring(model, cfg, byte_ids)
    del model
    torch.cuda.empty_cache()
    model = llama_init_params(torch.Generator(device=dev).manual_seed(11), cfg, dtype=torch.bfloat16)
    quantize_model(model, RtnConfig(weight_dtype="int8", group_size=128))
    profile_decode(model, cfg, prompt, "int8")
    del model
    torch.cuda.empty_cache()
    cold_gemv(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
