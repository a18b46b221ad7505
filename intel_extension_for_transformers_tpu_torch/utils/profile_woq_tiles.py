"""Time K1's, K2's and K3's tensor-core tiles on the card beside their yardsticks.

For the Llama-2-7B products (4096 -> 4096, 4096 -> 11008, 11008 -> 4096, and
4096 -> 32000 for K3), sym g128, bf16 x (int4 for K1 and K3, int8 for K2),
one weight timed again and again (L2-warm, through the wrapper, CUDA events
over 20 calls):

  * K1 (khalf): the split-K GEMV at M = 1-8 against the tiles at M = 1-16
    (the GEMV crossover that sets `K1_GEMV_MAX_M`); the tiles at M = 16,
    512 and 1024, at 512 and 1024 with BM = 128 beside the planned 64;
  * K2 (int8): the split-K GEMV at M = 1-8 against the tiles at M = 1-16
    (the crossover that sets `K2_GEMV_MAX_M`); the tiles at M = 16, 512 and
    1024, at 512 and 1024 with BM = 128 beside the planned 64
    (`K2_TILE_MAX_BM`), and the SIMT tiles (f32 x's route, and K2's bf16
    route before the tensor cores) at every M beside them;
  * K3 (w32): the GEMV at M = 8 against the tiles at M = 8, 9 and 16; the
    tiles at M = 16, 512 and 2048 (BM = 64 beside the planned 128 at 512 and 2048);
  * beside each: its bound (bytes over 3.35 TB/s or operations over 989
    TFLOP/s), `torch._weight_int4pack_mm` on the same weight repacked once
    (checked within 2e-3 of the kernel's plain version first) and
    dequantize into bf16 + `torch.matmul` (the M >= 1024 branch's cost;
    K2's only yardstick: no one PyTorch call takes a group-scaled int8 weight);
  * K1 at the index scan (M = 16, K = 768, N = 100,000, g = 64) and the BGE
    3072 -> 768 product at M = 512;
  * at M <= 16, where the wrapper's host cost (~35-45 us a call) hides the
    kernels, the device time as well: 80 calls cycling through 8 copies of
    the weight (more than the 50 MB L2) replayed from a CUDA graph
    (`profile_llama.cold_ms`), for the GEMV, the tiles and the library call.

K3 keeps exact products (128 + v' times a bf16 x, scaled after the dot), so
the library call, which rounds each weight to bf16, is checked against the
plain version with that rounding (K1's, on the same weight in the khalf
layout) and its gap to K3's own plain version is reported beside it.

Every row is one JSON line with the card's name and power limit.

    python -m intel_extension_for_transformers_tpu_torch.utils.profile_woq_tiles
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from intel_extension_for_transformers_tpu_torch.ops import quant_matmul
from intel_extension_for_transformers_tpu_torch.ops.packing import (
    dequantize,
    from_decode_layout,
    quantize_groupwise,
    to_decode_layout,
    unpack_int4,
    w32_nibbles,
)
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import (
    woq_int4_cuda,
    woq_int8_cuda,
    woq_matmul_plain,
    woq_w32_cuda,
    woq_w32_plain,
)
from intel_extension_for_transformers_tpu_torch.utils.profile_llama import cold_ms, events_ms

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
LLAMA = ((4096, 4096, "qkvo"), (4096, 11008, "gate/up"), (11008, 4096, "down"))


def int4pack(u: torch.Tensor, scales: torch.Tensor, group_size: int) -> tuple:
    """Unsigned nibbles u (K, N) in [0, 15] with w = (u - 8) * s, repacked
    once for `torch._weight_int4pack_mm`: two K rows a byte with the even row
    high, bf16 scales and zero points of 0."""
    u = u.to(torch.int32).T.contiguous()  # (N, K)
    packed = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    s = scales.to(torch.bfloat16)
    return packed, group_size, torch.stack([s, torch.zeros_like(s)], dim=2).contiguous()  # (K/g, N, 2)


def int4pack_khalf(qt) -> tuple:
    """`int4pack` of a khalf sym int4 weight."""
    return int4pack(unpack_int4(qt.data, signed=True) + 8, qt.scales, qt.group_size)


def int4pack_w32(qt) -> tuple:
    """`int4pack` of a w32 sym weight: its biased nibbles are u already."""
    return int4pack(w32_nibbles(qt.data)[: qt.K], qt.scales[: qt.K // qt.group_size], qt.group_size)


def int4pack_mm(x: torch.Tensor, packed: tuple, _out_dtype=None) -> torch.Tensor:
    return torch._weight_int4pack_mm(x, *packed)


def bound_ms(M: int, K: int, N: int, qt) -> float:
    """The least time for x (M, K) bf16 . W (packed, scales) -> (M, N) bf16."""
    n_bytes = 2 * M * K + 2 * M * N + sum(t.numel() * t.element_size() for t in (qt.data, qt.scales))
    return max(n_bytes / HBM_BYTES_PER_S, 2 * M * K * N / BF16_OPS_PER_S) * 1e3


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float()) / torch.linalg.vector_norm(b.float()))


class _Override:
    """Set module attributes of quant_matmul for a while (the plans are
    cached by their arguments, so the cache is cleared on both sides)."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def __enter__(self):
        self.saved = {k: getattr(quant_matmul, k) for k in self.attrs}
        for k, v in self.attrs.items():
            setattr(quant_matmul, k, v)
        quant_matmul.tile_plan.cache_clear()

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(quant_matmul, k, v)
        quant_matmul.tile_plan.cache_clear()


def _time(fn, x, qt, **override) -> float:
    with _Override(**override):
        return events_ms(lambda: fn(x, qt, torch.bfloat16), 20)


def repack(make) -> tuple | str:
    """make() (an `int4pack` of a weight), or why torch refused it."""
    try:
        return make()
    except (RuntimeError, TypeError) as e:
        return f"refused the repack: {str(e).splitlines()[0][:120]}"


def library(x, packed, want) -> dict:
    """`torch._weight_int4pack_mm`'s time on a `repack`, after a check against `want`."""
    if isinstance(packed, str):
        return {"library_ms": None, "library": packed}
    try:
        got = int4pack_mm(x, packed)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return {"library_ms": None, "library": f"refused: {str(e).splitlines()[0][:120]}"}
    rel = _rel(got, want)
    if not rel <= 2e-3:
        return {"library_ms": None, "library": f"differs from the plain version by {rel:.3g}"}
    return {"library_ms": events_ms(lambda: int4pack_mm(x, packed), 20), "library_rel": rel}


def _cold(fn, x, qts, **override) -> float:
    with _Override(**override):
        return cold_ms(fn, x, qts)[0]


def dequant_matmul_ms(x, qt) -> float:
    return events_ms(lambda: torch.matmul(x, dequantize(qt, torch.bfloat16)), 10)


def k1_rows(card: str, K: int, N: int, label: str, g: int = 128, Ms=(1, 2, 4, 8, 9, 16, 512, 1024),
            gemv_check: bool = True) -> None:
    gen = torch.Generator(device="cuda").manual_seed(K + N)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
    qts = [quantize_groupwise(w.roll(i, 0), "int4", "sym", g) for i in range(8 if gemv_check else 1)]
    del w
    qt = qts[0]
    packed = repack(lambda: int4pack_khalf(qt))
    for M in Ms:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        want = woq_matmul_plain(x, qt, torch.bfloat16)
        row = dict(kernel="K1", label=label, M=M, K=K, N=N, g=g, card=card, bound_ms=bound_ms(M, K, N, qt))
        with _Override(K1_GEMV_MAX_M=0):  # the tiles, every M (the GEMV's rows too)
            rel = _rel(woq_int4_cuda(x, qt, torch.bfloat16), want)
        assert rel <= 2e-3, (label, M, rel)
        row["tiles_ms"] = _time(woq_int4_cuda, x, qt, K1_GEMV_MAX_M=0)
        if gemv_check and M <= 16:
            row["tiles_graph_ms"] = _cold(woq_int4_cuda, x, qts, K1_GEMV_MAX_M=0)
        if M >= 512:
            row["tiles_bm128_ms"] = _time(woq_int4_cuda, x, qt, K1_TILE_MAX_BM=128)
        if gemv_check and M <= 8:
            with _Override(K1_GEMV_MAX_M=8):
                row["gemv_ms"] = events_ms(lambda: woq_int4_cuda(x, qt, torch.bfloat16), 20)
                row["gemv_graph_ms"] = cold_ms(woq_int4_cuda, x, qts)[0]
        if M in (8, 16, 512, 1024):
            row.update(library(x, packed, want))
            if gemv_check and M <= 16 and row["library_ms"] is not None:
                row["library_graph_ms"] = cold_ms(int4pack_mm, x, [int4pack_khalf(q) for q in qts])[0]
            row["dequant_matmul_ms"] = dequant_matmul_ms(x, qt)
        print("profile_woq_tiles " + json.dumps(row), flush=True)


def k2_rows(card: str, K: int, N: int, label: str, Ms=(1, 2, 4, 8, 9, 16, 512, 1024)) -> None:
    gen = torch.Generator(device="cuda").manual_seed(K + N + 2)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
    qts = [quantize_groupwise(w.roll(i, 0), "int8", "sym", 128) for i in range(8)]
    del w
    qt = qts[0]
    simt = dict(k2_route=lambda *a: "simt")
    for M in Ms:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        want = woq_matmul_plain(x, qt, torch.bfloat16)
        row = dict(kernel="K2", label=label, M=M, K=K, N=N, g=128, card=card, bound_ms=bound_ms(M, K, N, qt))
        for name, override in (("tiles", dict(K2_GEMV_MAX_M=0)), ("simt", simt)):
            with _Override(**override):
                rel = _rel(woq_int8_cuda(x, qt, torch.bfloat16), want)
            assert rel <= 2e-3, (label, M, name, rel)
            row[f"{name}_ms"] = _time(woq_int8_cuda, x, qt, **override)
            if M <= 16:
                row[f"{name}_graph_ms"] = _cold(woq_int8_cuda, x, qts, **override)
        if M >= 512:
            row["tiles_bm128_ms"] = _time(woq_int8_cuda, x, qt, K2_TILE_MAX_BM=128)
        if M <= 8:
            with _Override(K2_GEMV_MAX_M=8):
                assert _rel(woq_int8_cuda(x, qt, torch.bfloat16), want) <= 2e-3
                row["gemv_ms"] = events_ms(lambda: woq_int8_cuda(x, qt, torch.bfloat16), 20)
                row["gemv_graph_ms"] = cold_ms(woq_int8_cuda, x, qts)[0]
        if M >= 9:
            row["dequant_matmul_ms"] = dequant_matmul_ms(x, qt)
        print("profile_woq_tiles " + json.dumps(row), flush=True)


def k3_rows(card: str, K: int, N: int, label: str, Ms=(1, 8, 9, 16, 512, 2048)) -> None:
    gen = torch.Generator(device="cuda").manual_seed(K + N + 1)
    w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
    qts = [to_decode_layout(quantize_groupwise(w.roll(i, 0), "int4", "sym", 128)) for i in range(8)]
    del w
    qt = qts[0]
    packed = repack(lambda: int4pack_w32(qt))
    for M in Ms:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        want = woq_w32_plain(x, qt, torch.bfloat16)
        got = woq_w32_cuda(x, qt, torch.bfloat16)
        assert _rel(got, want) <= 2e-3, (label, M)
        row = dict(kernel="K3", label=label, M=M, K=K, N=N, g=128, card=card, bound_ms=bound_ms(M, K, N, qt),
                   ms=events_ms(lambda: woq_w32_cuda(x, qt, torch.bfloat16), 3 if M == 2048 else 20))
        if M <= 16:
            row["graph_ms"] = cold_ms(woq_w32_cuda, x, qts)[0]
        if M <= quant_matmul.K3_GEMV_MAX_M:  # the GEMV above, the tiles forced here
            row["tiles_ms"] = _time(woq_w32_cuda, x, qt, K3_GEMV_MAX_M=0)
            row["tiles_graph_ms"] = _cold(woq_w32_cuda, x, qts, K3_GEMV_MAX_M=0)
        if M >= 512:
            row["tiles_bm64_ms"] = _time(woq_w32_cuda, x, qt, tile_bm=lambda m, max_bm=128: 64)
        if M in (1, 16, 2048):
            # the library rounds each weight to bf16, as K1 does: checked against K1's plain version
            row.update(library(x, packed, woq_matmul_plain(x, from_decode_layout(qt), torch.bfloat16)))
            if row["library_ms"] is not None:
                row["library_vs_k3_plain_rel"] = _rel(int4pack_mm(x, packed), want)
                if M <= 16:
                    row["library_graph_ms"] = cold_ms(int4pack_mm, x, [int4pack_w32(q) for q in qts])[0]
        if M in (16, 512, 2048):
            row["dequant_matmul_ms"] = dequant_matmul_ms(x, qt)
        print("profile_woq_tiles " + json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_woq_tiles: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    for K, N, label in LLAMA:
        k1_rows(card, K, N, label)
    k1_rows(card, 768, 100_000, "index scan", g=64, Ms=(16,), gemv_check=False)
    k1_rows(card, 3072, 768, "bge ffn_out", Ms=(512,), gemv_check=False)
    for K, N, label in LLAMA:
        k2_rows(card, K, N, label)
    for K, N, label in LLAMA + ((4096, 32000, "lm_head shape"),):
        k3_rows(card, K, N, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
