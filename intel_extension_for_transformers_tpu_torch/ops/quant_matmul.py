"""Weight-only-quantized matmul, with the hand-written GEMMs K1, K2 and K3.

Port of `intel_extension_for_transformers_tpu/ops/quant_matmul.py`:

1. `woq_matmul_ref`: dequantize to f32, then an f32 matmul. The oracle.
2. `woq_matmul`: the reference's dispatch. A weight in the w32 decode
   layout (`packing.prepare_for_inference`) goes to K3, `csrc/woq_w32.cu`,
   at every M, before any other branch, as the JAX package sends it to
   `_pallas_woq_w32`. For a khalf weight, at M >= 1024 rows the weight is
   dequantized once into the compute dtype and multiplied with
   `torch.matmul` (the JAX package's dequantize-once branch; M >= 1024 was
   chosen on a TPU). Below that a 4-bit weight goes to K1,
   `csrc/woq_int4.cu`, and an int8 weight to K2, `csrc/woq_int8.cu`. K1, K2
   and K3 each run a split-K GEMV at decode (`csrc/woq_gemv.cuh`) and tiles
   above, on the tensor cores for bf16 x (`csrc/woq_tc.cuh`); none writes the
   dequantized weight to device memory. K1, K2 and K3 take every shape the
   packing allows, so there is no fallback for unfriendly shapes.
3. `woq_linear` and the `WOQLinear` module: a linear layer over a
   `QuantizedTensor`, held as buffers.

Compute is f32 when x is f32 (full f32, no TF32) and bf16 otherwise; the
accumulator is always f32. No backward is defined; the port serves
inference only so far.
"""

from __future__ import annotations

import functools
import math
from dataclasses import replace
from typing import Optional

import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.ops.codebooks import get_codebook
from intel_extension_for_transformers_tpu_torch.ops.packing import (
    QuantizedTensor,
    dequantize,
    unpack_int4,
    w32_nibbles,
)

DEQUANT_ONCE_MIN_M = 1024
_SCHEME_IDS = {"sym": 0, "asym": 1, "codebook": 2}


def woq_matmul_ref(
    x: torch.Tensor, qt: QuantizedTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Dequantize-then-matmul ground truth in f32. x: (..., K) → (..., N)."""
    w = dequantize(qt, dtype=torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype or x.dtype)


def woq_matmul_plain(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """The plain PyTorch version of K1 (4-bit weights) and K2 (int8), with
    the kernels' rounding.

    x2 (M, K) in the compute dtype. The scale (and zero point) are cast to
    the compute dtype and q·s or (q−z)·s is taken in that dtype, as the
    Pallas kernels do; the product accumulates in f32.
    """
    cd = x2.dtype
    g = qt.group_size
    if qt.bits == 4:
        idx = unpack_int4(qt.data, signed=qt.scheme == "sym" and not qt.is_codebook)
    else:
        idx = qt.data
    if qt.is_codebook:
        cb = torch.as_tensor(get_codebook(qt.weight_dtype), device=idx.device)
        q = cb[idx.to(torch.int64)].to(cd)
    elif qt.scheme == "asym":  # stored as wrapped unsigned values
        q = (idx.to(torch.int32) & 0xFF).to(cd)
    else:
        q = idx.to(cd)
    q = q.reshape(qt.K // g, g, qt.N)
    s = qt.scales.to(torch.float32).to(cd)[:, None, :]
    if qt.scheme == "asym":
        q = q - qt.zeros.to(torch.float32).to(cd)[:, None, :]
    w = (q * s).reshape(qt.K, qt.N)
    out = torch.matmul(x2.to(torch.float32), w.to(torch.float32))
    return out.to(out_dtype)


# K1 runs its split-K GEMV (which takes up to 8 rows) up to this many rows,
# tiles above: on the H100 the tensor-core tiles beat the GEMV from M = 2 on
# the Llama-2-7B products by device time, the GEMV keeps M = 1 (PERF.md)
K1_GEMV_MAX_M = 1
_GEMV_COLS = 128  # columns of one K1 or K2 GEMV block (a strip)
_k1_counters: dict = {}  # (device, stream, count) → int32 arrival counters, one a strip or tile
_TILE_BN = 128  # columns of one tensor-core tile (csrc/woq_tc.cuh)
# K1's tensor-core tiles take at most 64 rows a tile (two blocks an SM): on
# the H100 faster than 128 from M = 512 (PERF.md)
K1_TILE_MAX_BM = 64
_ROUTES = {"simt": 0, "gemv": 1, "tiles": 2}  # K1's and K2's kernels, as their C entry points number them


@functools.lru_cache(maxsize=None)
def target_blocks(device_index: int) -> int:
    """The blocks K1's, K2's and K3's split-K plans aim for on a card: two
    for each of its SMs (264 on an H100 SXM's 132)."""
    return 2 * torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def gemv_k_chunk(N: int, span: int, group_size: int, target: int) -> int:
    """Rows of the walk that one block of the K1 or K2 GEMV sums (`span`
    when not split): K1 walks K/2 packed rows, K2 K rows.

    The span is split on group boundaries until the strips of 128 columns
    times the splits reach `target` blocks, or every split is one group.
    """
    want = -(-target // -(-N // _GEMV_COLS))  # splits wanted
    units = span // group_size
    if want <= 1 or units <= 1:
        return span
    return max(units // want, 1) * group_size  # at least `want` splits


def int4_k_chunk(N: int, K: int, group_size: int, target: int) -> int:
    """`gemv_k_chunk` of K1, whose GEMV walks K/2 packed rows (a chunk of g
    of them covers one low-plane and one high-plane group)."""
    return gemv_k_chunk(N, K // 2, group_size, target)


def tile_bm(M: int, max_bm: int = 128) -> int:
    """Rows of one tensor-core output tile: the least of 16, 32, 64 and 128
    that holds M, else the largest; at most max_bm."""
    return min(next((bm for bm in (16, 32, 64) if M <= bm), 128), max_bm)


@functools.lru_cache(maxsize=1024)
def tile_plan(M: int, N: int, span: int, group_size: int, target: int, max_bm: int = 128) -> tuple:
    """(BM, k_chunk) of a tensor-core tile launch of K1 (max_bm 64) or K3.

    The walk is `span` rows of K (K1: K/2 packed rows; K3: K rounded up to
    g), split on group boundaries when the BM x 128 output tiles are fewer
    than `target` blocks: the splits, about equal, reach `target` blocks or
    are one group each. k_chunk == span: no split.
    """
    bm = tile_bm(M, max_bm)
    return bm, split_chunk(-(-N // _TILE_BN) * -(-M // bm), span, group_size, target)


def split_chunk(tiles: int, span: int, unit: int, target: int) -> int:
    """Rows of the walk that one split of `tiles` output tiles takes: `span`
    split on `unit` boundaries, about equally, until the tiles times the
    splits reach `target` blocks or every split is one unit (the span when
    not split)."""
    want = -(-target // tiles)  # splits wanted
    units = -(-span // unit)
    if want <= 1 or units <= 1:
        return span
    chunk = -(-units // want)
    while chunk > 1 and -(-units // chunk) < want:
        chunk -= 1
    chunk = -(-units // -(-units // chunk))  # the same splits, as equal as they go
    return min(chunk * unit, span)


# K3 runs its split-K GEMV (csrc/woq_w32_gemv.cu, which takes up to 8 rows)
# up to this many rows where the tensor-core tiles can take the product,
# tiles above: on the H100 the tiles beat the GEMV from M = 2 on the
# Llama-2-7B products by device time; f32 x keeps the GEMV up to 8 rows,
# 6-15x faster there than the SIMT tiles (PERF.md)
K3_GEMV_MAX_M = 1
_GEMV_ROWS = 8  # the most rows K1's, K2's and K3's GEMVs take
# x values one block of K3's GEMV stages in shared memory: its rows of x
# (1 at M = 1, else 8) times its split's rows of K (csrc/woq_w32_gemv.cu kXFloats)
W32_GEMV_X_FLOATS = 8192


def _tile_route(x2: torch.Tensor, M: int, group_size: int, gemv_max_m: int) -> bool:
    """Whether K1, K2 or K3 takes the tensor-core tiles: above its GEMV's
    rows, with bf16 x and a group size that is a multiple of 32."""
    return x2.dtype == torch.bfloat16 and M > gemv_max_m and group_size % 32 == 0


@functools.lru_cache(maxsize=1024)
def w32_k_chunk(N: int, K: int, M: int, target: int) -> int:
    """Rows of K that one block of K3's GEMV walks (x2 (M, K), N columns).

    The walk is K rounded up to 512: whole 512-row blocks of the w32 words,
    so each 16-row span of a plane lies in one group. It is split on 512-row
    boundaries, about equally, until the strips of 128 columns times the
    splits reach `target` blocks or every split is one block
    (`split_chunk`), and into at most W32_GEMV_X_FLOATS // TM rows, TM the
    GEMV's rows (1 at M = 1, else 8), so a block's x fits in its shared
    memory.
    """
    chunk = split_chunk(-(-N // _GEMV_COLS), _round_up(K, 512), 512, target)
    return min(chunk, W32_GEMV_X_FLOATS // (1 if M == 1 else _GEMV_ROWS))


def k3_route(x2: torch.Tensor, M: int, group_size: int) -> str:
    """K3's kernel for x2 (M, K): "gemv" (M <= K3_GEMV_MAX_M), the
    tensor-core "tiles" above it (bf16 x, g a multiple of 32), the GEMV again
    up to its 8 rows for the rest (f32 x, or g not a multiple of 32), and
    the "simt" tiles above."""
    if M <= K3_GEMV_MAX_M:
        return "gemv"
    if _tile_route(x2, M, group_size, K3_GEMV_MAX_M):
        return "tiles"
    return "gemv" if M <= _GEMV_ROWS else "simt"


def k1_route(x2: torch.Tensor, M: int, group_size: int) -> str:
    """K1's kernel for x2 (M, K): "gemv" (M <= K1_GEMV_MAX_M), the
    tensor-core "tiles" or the "simt" tiles."""
    if M <= K1_GEMV_MAX_M:
        return "gemv"
    return "tiles" if _tile_route(x2, M, group_size, K1_GEMV_MAX_M) else "simt"


def _strip_counters(dev: torch.device, stream: torch.cuda.Stream, strips: int) -> torch.Tensor:
    """Split-K arrival counters for `strips` column strips (K1's and K2's
    GEMVs) or output tiles (K1's, K2's and K3's tiles) on `stream`: zeroed when
    made, and every launch leaves them at 0. One tensor for each (device,
    stream, strips), made once and kept, so a decode step zeroes nothing,
    launches on two streams never share a counter, and a CUDA graph keeps
    valid pointers. None is made during a capture: run the kernel at that
    shape once on the capturing stream before capturing."""
    key = (dev, stream.cuda_stream, strips)
    counters = _k1_counters.get(key)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"no split-K counters for {strips} strips or tiles on the capturing stream: "
                               "run the kernel once there before the capture")
        counters = torch.zeros(strips, dtype=torch.int32, device=dev)
        _k1_counters[key] = counters
    return counters


def _split_workspace(dev, M: int, N: int, span: int, k_chunk: int, count: int, out: torch.Tensor):
    """(part, counters) of a launch that splits `span` rows into k_chunk
    ones: f32 partials a call and the stream's kept counters, `count` of
    them; `out` twice (unread) without a split."""
    splits = -(-span // k_chunk)
    if splits == 1:
        return out, out
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    return part, _strip_counters(dev, torch.cuda.current_stream(dev), count)


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _gemv_vec(N: int, data: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor) -> int:
    """The weight loads K1's and K2's GEMVs may take: 2 for 16-byte words,
    1 for 4-byte words (scales and zero points 16-byte), 0 byte by byte."""
    aligned = _aligned16(scales, zeros)
    if N % 16 == 0 and _aligned16(data) and aligned:
        return 2
    if N % 4 == 0 and data.data_ptr() % 4 == 0 and aligned:
        return 1
    return 0


def woq_int4_cuda(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Launch K1 on x2 (M, K), f32 or bf16, on a CUDA device: the split-K
    GEMV at M <= K1_GEMV_MAX_M; above it the tensor-core tiles for bf16 x
    with g a multiple of 32, else the SIMT tiles (`k1_route`). One launch
    either way."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    M, K = x2.shape
    dev = x2.device
    g = qt.group_size
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on a CUDA device, got {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 takes f32 or bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 writes f32 or bf16, got {out_dtype}")
    if qt.bits != 4 or qt.data.shape != (K // 2, qt.N) or qt.data.device != dev:
        raise ValueError("K1 needs a khalf int4 weight of shape (K/2, N) on x's device")
    if (K // 2) % g or qt.scales.shape != (K // g, qt.N):
        raise ValueError(f"group_size {g} must divide K/2 = {K // 2}")
    x2 = x2.contiguous()
    data = qt.data.contiguous()
    scales = qt.scales.to(torch.float32).contiguous()
    if qt.is_codebook:
        scheme = "codebook"
        codebook = torch.as_tensor(get_codebook(qt.weight_dtype), device=dev)
    else:
        scheme = qt.scheme
        codebook = scales  # unread by the kernel
    zeros = qt.zeros.to(torch.float32).contiguous() if scheme == "asym" else scales
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    if M == 0 or qt.N == 0:
        return out
    K2, N = K // 2, qt.N
    bm, route = 0, k1_route(x2, M, g)
    if route == "gemv":
        k_chunk = int4_k_chunk(N, K, g, target_blocks(dev.index))
        count = -(-N // _GEMV_COLS)
        vec = _gemv_vec(N, data, scales, zeros)
    elif route == "simt":
        k_chunk, count, vec = K2, 0, 0
    else:
        bm, k_chunk = tile_plan(M, N, K2, g, target_blocks(dev.index), K1_TILE_MAX_BM)
        count = -(-N // _TILE_BN) * -(-M // bm)
        vec = int(K % 16 == 0 and _aligned16(x2)) + 2 * int(N % 16 == 0 and _aligned16(data))
    part, counters = _split_workspace(dev, M, N, K2, k_chunk, count, out)
    status = load_kernels().itx_woq_int4(
        x2.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        codebook.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        M, N, K, g, _SCHEME_IDS[scheme], _ROUTES[route], bm, k_chunk, vec,
        int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_woq_int4")
    woq_int4_cuda.launches += 1
    woq_int4_cuda.tile_launches += route == "tiles"
    woq_int4_cuda.launches_by_m[M] = woq_int4_cuda.launches_by_m.get(M, 0) + 1
    return out


woq_int4_cuda.launches = 0
woq_int4_cuda.tile_launches = 0  # the launches of the tensor-core tiles among them
woq_int4_cuda.launches_by_m = {}  # M → the launches at that many rows

# K2 runs its split-K GEMV (which takes up to 8 rows) up to this many rows,
# tiles above (PERF.md)
K2_GEMV_MAX_M = 1
# K2's tensor-core tiles take at most 64 rows a tile (two blocks an SM): on
# the H100 faster than 128 from M = 512 (PERF.md)
K2_TILE_MAX_BM = 64
_K2_SIMT_BN, _K2_SIMT_K = 64, 32  # K2's SIMT tiles: columns a tile, K rows a step


def k2_route(x2: torch.Tensor, M: int, group_size: int) -> str:
    """K2's kernel for x2 (M, K): "gemv" (M <= K2_GEMV_MAX_M), the
    tensor-core "tiles" (bf16 x, g a multiple of 32) or the "simt" tiles."""
    if M <= K2_GEMV_MAX_M:
        return "gemv"
    return "tiles" if _tile_route(x2, M, group_size, K2_GEMV_MAX_M) else "simt"


def woq_int8_cuda(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Launch K2 on x2 (M, K), f32 or bf16, on a CUDA device: the split-K
    GEMV at M <= K2_GEMV_MAX_M; above it the tensor-core tiles for bf16 x
    with g a multiple of 32, else the SIMT tiles (`k2_route`). One launch
    either way."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    M, K = x2.shape
    dev = x2.device
    g = qt.group_size
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on a CUDA device, got {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 takes f32 or bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 writes f32 or bf16, got {out_dtype}")
    if (qt.bits != 8 or qt.layout != "khalf" or qt.data.dtype != torch.int8
            or qt.data.shape != (K, qt.N) or qt.data.device != dev):
        raise ValueError("K2 needs an int8 weight of shape (K, N) on x's device")
    if K % g or qt.scales.shape != (K // g, qt.N):
        raise ValueError(f"group_size {g} must divide K = {K}")
    x2 = x2.contiguous()
    data = qt.data.contiguous()
    scales = qt.scales.to(torch.float32).contiguous()
    asym = qt.scheme == "asym"
    zeros = qt.zeros.to(torch.float32).contiguous() if asym else scales  # unread for sym
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    if M == 0 or qt.N == 0:
        return out
    N, target = qt.N, target_blocks(dev.index)
    bm, route = 0, k2_route(x2, M, g)
    if route == "gemv":
        k_chunk, count, vec = gemv_k_chunk(N, K, g, target), -(-N // _GEMV_COLS), _gemv_vec(N, data, scales, zeros)
    elif route == "simt":
        count = -(-N // _K2_SIMT_BN) * -(-M // (16 if M <= 16 else 64))
        k_chunk, vec = split_chunk(count, K, _K2_SIMT_K, target), 0
    else:
        bm, k_chunk = tile_plan(M, N, K, g, target, K2_TILE_MAX_BM)
        count = -(-N // _TILE_BN) * -(-M // bm)
        vec = int(K % 8 == 0 and _aligned16(x2)) + 2 * int(N % 16 == 0 and _aligned16(data))
    part, counters = _split_workspace(dev, M, N, K, k_chunk, count, out)
    status = load_kernels().itx_woq_int8(
        x2.data_ptr(), data.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        M, N, K, g, int(asym), _ROUTES[route], bm, k_chunk, vec,
        int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "itx_woq_int8")
    woq_int8_cuda.launches += 1
    woq_int8_cuda.tile_launches += route == "tiles"
    return out


woq_int8_cuda.launches = 0
woq_int8_cuda.tile_launches = 0  # the launches of the tensor-core tiles among them


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def w32_m1_path(M: int, group_size: int) -> bool:
    """The JAX w32 kernel's branch gate: scale after a per-group dot (m1)
    when g >= 128 or the row tile min(round_up(M, 8), 256) is <= 32; else
    fold offset and scale into the weight before the dot."""
    tm = min(_round_up(max(M, 1), 8), 256)
    return group_size >= 128 or tm <= 32


def woq_w32_plain(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """K3's plain PyTorch version: both branches of the JAX w32 kernel.

    The words decode to 128 + v' (v' the biased nibble), exact in bf16.
    m1 branch: per-group dots of x (compute dtype) with 128 + v', summed in
    f32, times the f32 scale; then s * zc * sum(x_g) is subtracted in f32.
    Fold branch: ((128 + v') - zc) * s in f32, rounded to the compute dtype,
    then one dot with f32 accumulation (K1's rounding of q * s). The m1
    branch takes 256 rows at a time so its (G, rows, N) partials stay small.
    """
    M = x2.shape[0]
    g = qt.group_size
    cd = x2.dtype
    Kp = qt.data.shape[0] * 8
    x2 = torch.nn.functional.pad(x2, (0, Kp - x2.shape[1]))  # zero rows meet padded words
    scales = qt.scales.to(torch.float32)
    # the offset the biased words carry: 136 = 128 + 8 for sym, 128 + z for asym
    zc = qt.zeros.to(torch.float32) + 128.0 if qt.scheme == "asym" else torch.full_like(scales, 136.0)
    G = scales.shape[0]
    planes = w32_nibbles(qt.data).to(torch.float32) + 128.0  # (Kp, N), exact
    if w32_m1_path(M, g):
        wg = planes.reshape(G, g, qt.N)
        corr = scales * zc  # (G, N)
        outs = []
        for r in range(0, M, 256):
            xc = x2[r : r + 256].to(torch.float32)  # values of the compute dtype
            xg = xc.reshape(-1, G, g).transpose(0, 1)  # (G, rows, g)
            parts = torch.bmm(xg, wg)  # (G, rows, N) f32 partial sums
            acc = (parts * scales[:, None, :]).sum(dim=0)
            acc = acc - xg.sum(dim=2).T @ corr
            outs.append(acc)
        out = torch.cat(outs, dim=0) if outs else x2.new_zeros((0, qt.N), dtype=torch.float32)
    else:
        w = (planes.reshape(G, g, qt.N) - zc[:, None, :]) * scales[:, None, :]
        w = w.reshape(G * g, qt.N).to(cd).to(torch.float32)
        out = x2.to(torch.float32) @ w
    return out.to(out_dtype)


def woq_w32_cuda(
    x2: torch.Tensor, qt: QuantizedTensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Launch K3 on x2 (M, K), f32 or bf16, on a CUDA device: the split-K
    GEMV, the tensor-core tiles or the SIMT tiles, as `k3_route` picks. One
    launch either way."""
    from intel_extension_for_transformers_tpu_torch.ops.kernels import (
        check,
        load_kernels,
    )

    M, K = x2.shape
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on a CUDA device, got {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 takes f32 or bf16 activations, got {x2.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 writes f32 or bf16, got {out_dtype}")
    Kp = qt.data.shape[0] * 8
    g = qt.group_size
    if qt.layout != "w32" or qt.data.dtype != torch.int32 or qt.data.device != dev:
        raise ValueError("K3 needs a w32 weight (int32 words) on x's device")
    if Kp % 512 or Kp % g or qt.scales.shape != (Kp // g, qt.N) or K > Kp:
        raise ValueError(f"w32 words {tuple(qt.data.shape)} do not fit K={K}, g={g}")
    if g % 16:
        raise ValueError(f"K3 needs group_size % 16 == 0, got {g}")
    x2 = x2.contiguous()
    words = qt.data.contiguous()
    scales = qt.scales.to(torch.float32).contiguous()
    asym = qt.scheme == "asym"
    zeros = qt.zeros.to(torch.float32).contiguous() if asym else scales  # unread for sym
    out = torch.empty((M, qt.N), dtype=out_dtype, device=dev)
    if M == 0 or qt.N == 0:
        return out
    N, route = qt.N, k3_route(x2, M, g)
    stream = torch.cuda.current_stream(dev).cuda_stream
    x_bf16, out_bf16 = int(x2.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)
    splits = 1
    if route == "gemv":
        span = _round_up(K, 512)
        k_chunk = w32_k_chunk(N, K, M, target_blocks(dev.index))
        vec = int(N % 4 == 0 and _aligned16(words, scales, zeros))
        part, counters = _split_workspace(dev, M, N, span, k_chunk, -(-N // _GEMV_COLS), out)
        splits = -(-span // k_chunk)
        status = load_kernels().itx_woq_w32_gemv(
            x2.data_ptr(), words.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), M, N, K, g, int(asym), k_chunk, vec, x_bf16, out_bf16, stream)
        name = "itx_woq_w32_gemv"
    else:
        bm, k_chunk, vec, part, counters = 0, 0, 0, out, out  # bm 0: the SIMT tiles, which read neither
        if route == "tiles":
            span = _round_up(K, g)
            bm, k_chunk = tile_plan(M, N, span, g, target_blocks(dev.index))
            vec = int(K % 8 == 0 and _aligned16(x2)) + 2 * int(N % 4 == 0 and _aligned16(words))
            part, counters = _split_workspace(dev, M, N, span, k_chunk, -(-N // _TILE_BN) * -(-M // bm), out)
        status = load_kernels().itx_woq_w32(
            x2.data_ptr(), words.data_ptr(), scales.data_ptr(), zeros.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), M, N, K, Kp, g, int(asym), int(w32_m1_path(M, g)), bm,
            k_chunk, vec, x_bf16, out_bf16, stream)
        name = "itx_woq_w32"
    check(status, name)
    woq_w32_cuda.launches += 1
    woq_w32_cuda.tile_launches += route == "tiles"
    woq_w32_cuda.gemv_launches += route == "gemv"
    woq_w32_cuda.split_gemv_launches += splits > 1
    return out


woq_w32_cuda.launches = 0
woq_w32_cuda.tile_launches = 0  # the launches of the tensor-core tiles among them
woq_w32_cuda.gemv_launches = 0  # the launches of the split-K GEMV among them
woq_w32_cuda.split_gemv_launches = 0  # the GEMV's launches that split K


def woq_matmul(
    x: torch.Tensor, qt: QuantizedTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """x (..., K) @ dequant(qt) (K, N) → (..., N).

    On a CUDA tensor a w32 weight launches K3 at every M, a khalf 4-bit
    weight at M < 1024 launches K1 and an int8 weight K2, or they raise; the
    plain versions run only for a CPU tensor.
    """
    if qt.pre_scale is not None:
        # AWQ/TEQ/SmoothQuant folding: diag(pre_scale) @ W applied to x instead
        x = x * qt.pre_scale.to(x.dtype)
    out_dtype = out_dtype or x.dtype
    batch_shape = x.shape[:-1]
    K = x.shape[-1]
    if K != qt.K:
        raise ValueError(f"x last dim {K} != quantized weight K {qt.K}")
    M = math.prod(batch_shape)
    cd = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    x2 = x.reshape(M, K).to(cd)

    if qt.layout == "w32":
        # before the dequantize-once branch, as in the JAX package
        if x2.device.type == "cpu":
            out = woq_w32_plain(x2, qt, out_dtype)
        else:
            out = woq_w32_cuda(x2, qt, out_dtype)
    elif M >= DEQUANT_ONCE_MIN_M:
        # compute-bound regime: decode the weight once, then a plain matmul
        out = torch.matmul(x2, dequantize(qt, dtype=cd))
    elif x2.device.type == "cpu":
        out = woq_matmul_plain(x2, qt, out_dtype)
    elif qt.bits == 4:
        out = woq_int4_cuda(x2, qt, out_dtype)
    else:
        out = woq_int8_cuda(x2, qt, out_dtype)
    return out.to(out_dtype).reshape(*batch_shape, qt.N)


def woq_linear(
    x: torch.Tensor,
    qt: QuantizedTensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Linear layer on a quantized weight."""
    out = woq_matmul(x, qt, out_dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class WOQLinear(nn.Module):
    """Inference linear layer over a packed weight.

    The packed data, scales, zero points and pre-scale are buffers, so
    `.to(device)` and `state_dict()` carry them; the layout metadata are plain
    attributes. Replaces `nn.Linear` in a quantized model
    (`quantization.quantize_model`).
    """

    def __init__(self, qt: QuantizedTensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.set_qt(qt)
        self.register_buffer("bias", bias)

    def set_qt(self, qt: QuantizedTensor) -> None:
        """Hold `qt` (e.g. after a layout change), replacing the buffers."""
        for name in ("data", "scales", "zeros", "pre_scale"):
            self.register_buffer(name, getattr(qt, name))
        self._meta = replace(qt, data=None, scales=None, zeros=None, pre_scale=None)

    @property
    def qt(self) -> QuantizedTensor:
        return replace(
            self._meta, data=self.data, scales=self.scales, zeros=self.zeros,
            pre_scale=self.pre_scale,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return woq_linear(x, self.qt, self.bias)

    def extra_repr(self) -> str:
        m = self._meta
        return (f"K={m.K}, N={m.N}, {m.weight_dtype}/{m.scheme}, "
                f"group_size={m.group_size}, layout={m.layout}")
