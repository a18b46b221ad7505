"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips on a host without a CUDA device. This file
imports no jax (the machine with the card has none). Run it there with
`python -m pytest tests/test_torch_cuda_kernels.py -m cuda -p no:cacheprovider`.
"""

import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu_torch.ops import packing, quant_matmul, scan_topk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_cuda()


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).float()) / torch.linalg.vector_norm(b.float()))


# K1 against its plain twin, which rounds the same way: the two differ only in
# summation order, so f32 and bf16 compute both hold 1e-5 relative (the bf16
# output itself is rounded, which the 2e-3 bound of bf16 output covers).
@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-3),
    (torch.float32, torch.bfloat16, 2e-3),
])
@pytest.mark.parametrize("weight_dtype,scheme,M,K,N,g", [
    ("int4", "sym", 1, 768, 768, 128),
    ("int4", "sym", 37, 3072, 768, 128),
    ("int4", "asym", 64, 768, 3072, 128),
    ("nf4", "sym", 16, 768, 1000, 64),
    ("fp4", "sym", 5, 256, 300, 32),
    ("int3", "asym", 200, 512, 257, 64),
])
def test_woq_int4_kernel_matches_plain(dev, weight_dtype, scheme, M, K, N, g, x_dtype, out_dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, device=dev, generator=gen).to(x_dtype)
    w = torch.randn(K, N, device=dev, generator=gen) * 0.05
    qt = packing.quantize_groupwise(w, weight_dtype, scheme, g)
    got = quant_matmul.woq_int4_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_matmul_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol


# K1's split-K GEMV against the same plain twin and bars, at each M its
# kernel takes (1-8; `woq_matmul` sends it M <= K1_GEMV_MAX_M = 1, the tiles
# beating it above on the card). N = 4096 and 11008 take 16-byte weight
# words at M = 1, N = 4100 (not a multiple of 16) 4-byte words; K/2 = 2048
# splits over 4-8 blocks a strip.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("weight_dtype,scheme", [("int4", "sym"), ("int4", "asym"), ("nf4", "sym"), ("fp4", "sym")])
@pytest.mark.parametrize("N", [4096, 11008, 4100])
def test_woq_int4_gemv_matches_plain(dev, monkeypatch, N, weight_dtype, scheme, M, dtype, tol):
    monkeypatch.setattr(quant_matmul, "K1_GEMV_MAX_M", 8)
    K = 4096
    gen = torch.Generator(device=dev).manual_seed(M + N)
    x = torch.randn(M, K, device=dev, generator=gen).to(dtype)
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, weight_dtype, scheme, 128)
    assert -(-(K // 2) // quant_matmul.int4_k_chunk(N, K, 128, quant_matmul.target_blocks(dev.index))) > 1
    before = quant_matmul.woq_int4_cuda.launches
    got = quant_matmul.woq_int4_cuda(x, qt, dtype)
    again = quant_matmul.woq_int4_cuda(x, qt, dtype)
    want = quant_matmul.woq_matmul_plain(x, qt, dtype)
    torch.cuda.synchronize()
    assert quant_matmul.woq_int4_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, again)
    assert _rel(got, want) <= tol
    key = (x.device, torch.cuda.current_stream().cuda_stream, -(-N // 128))
    assert not quant_matmul._k1_counters[key].any()  # the strips' counters are back to 0


# An x that starts 2 bytes past an aligned address (element loads), with one
# split (K/2 = 128 is one group) and with several; and odd N (byte loads).
@pytest.mark.parametrize("K,N,g", [(256, 4096, 128), (4096, 4096, 128), (4096, 1001, 64)])
def test_woq_int4_gemv_unaligned_x_and_splits(dev, K, N, g):
    gen = torch.Generator(device=dev).manual_seed(K + N)
    base = torch.randn(1, K + 1, device=dev, generator=gen).to(torch.bfloat16)
    x = base[:, 1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, "int4", "sym", g)
    got = quant_matmul.woq_int4_cuda(x, qt, torch.float32)
    want = quant_matmul.woq_matmul_plain(x.contiguous(), qt, torch.float32)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, quant_matmul.woq_int4_cuda(x, qt, torch.float32))


def test_woq_int4_small_m_reaches_the_gemv(dev):
    """M = 1 launches the split-K GEMV, which makes the stream's strip
    counters at first use (32 strips here); M = 9 in f32 the SIMT tiles,
    which need none; M = 8 and 9 in bf16 the tensor-core tiles, split 16
    ways over 32 output tiles, which need 32 counters too. `woq_matmul`
    sends a khalf int4 weight at M < 1024 to K1, once."""
    gen = torch.Generator(device=dev).manual_seed(3)
    K, N = 4096, 4096
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, "int4", "sym", 128)
    key = (dev, torch.cuda.current_stream().cuda_stream, N // 128)
    for M, dtype, counted in ((1, torch.bfloat16, True), (8, torch.bfloat16, True), (9, torch.float32, False),
                              (9, torch.bfloat16, True)):
        assert quant_matmul.k1_route(torch.empty(0, dtype=dtype), M, 128) == (
            "gemv" if M == 1 else "simt" if dtype == torch.float32 else "tiles")
        x = torch.randn(M, K, device=dev, generator=gen).to(dtype)
        quant_matmul._k1_counters.pop(key, None)
        before = quant_matmul.woq_int4_cuda.launches
        quant_matmul.woq_matmul(x, qt)
        torch.cuda.synchronize()
        assert quant_matmul.woq_int4_cuda.launches == before + 1
        assert (key in quant_matmul._k1_counters) == counted, (M, dtype)


def test_woq_int4_gemv_in_a_cuda_graph(dev):
    """The GEMV replays from a CUDA graph with the bits of an eager call,
    once it has run on the capturing stream; a capture on a stream it has
    not run on raises instead of making counters inside the graph."""
    gen = torch.Generator(device=dev).manual_seed(4)
    K, N = 4096, 4096 + 128
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, "int4", "sym", 128)
    x = torch.randn(1, K, device=dev, generator=gen).to(torch.bfloat16)
    want = quant_matmul.woq_int4_cuda(x, qt, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    quant_matmul._k1_counters.pop((x.device, side.cuda_stream, N // 128), None)
    with pytest.raises(RuntimeError, match="capturing stream"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            quant_matmul.woq_int4_cuda(x, qt, torch.bfloat16)
    with torch.cuda.stream(side):
        quant_matmul.woq_int4_cuda(x, qt, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = quant_matmul.woq_int4_cuda(x, qt, torch.bfloat16)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# K1's tensor-core tiles (bf16 x, M > 8, g a multiple of 32) against the
# same plain twin and bars as the other routes: the twin rounds q*s (or
# (q - z)*s, cb*s) to bf16 as the tiles do, the products are exact in f32,
# so an f32 output differs only in summation order (1e-5) and a bf16 output
# adds one rounding (2e-3). K/2 = 384 splits into up to 12 groups; N = 300
# and 1001 take byte loads of the weight, 4096 16-byte copies.
@pytest.mark.parametrize("out_dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("N", [300, 1001, 4096])
@pytest.mark.parametrize("weight_dtype,scheme", [
    ("int4", "sym"), ("int4", "asym"), ("nf4", "sym"), ("fp4", "sym"), ("int3", "asym"),
])
@pytest.mark.parametrize("M", [9, 16, 17, 63, 64, 333, 1023])
def test_woq_int4_tiles_match_plain(dev, M, weight_dtype, scheme, N, g, out_dtype, tol):
    K = 768
    gen = torch.Generator(device=dev).manual_seed(M + N + g)
    x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.05, weight_dtype, scheme, g)
    got = quant_matmul.woq_int4_cuda(x, qt, out_dtype)
    again = quant_matmul.woq_int4_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_matmul_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol
    assert torch.equal(got, again)


# K1's tiles at the Llama widths (K/2 split into several groups) on an x
# that starts 2 bytes past an aligned address (element copies) and on an
# aligned one.
@pytest.mark.parametrize("weight_dtype,scheme", [("int4", "sym"), ("int4", "asym"), ("nf4", "sym")])
@pytest.mark.parametrize("M,K,N,g", [(16, 4096, 4096, 128), (333, 4096, 1001, 64), (64, 11008, 4096, 128)])
def test_woq_int4_tiles_unaligned_x_and_llama_widths(dev, weight_dtype, scheme, M, K, N, g):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    base = torch.randn(M, K + 1, device=dev, generator=gen).to(torch.bfloat16)
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, weight_dtype, scheme, g)
    for x in (base[:, :K].contiguous(), base.flatten()[1:M * K + 1].view(M, K)):
        got = quant_matmul.woq_int4_cuda(x, qt, torch.float32)
        want = quant_matmul.woq_matmul_plain(x.contiguous(), qt, torch.float32)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5
        assert torch.equal(got, quant_matmul.woq_int4_cuda(x, qt, torch.float32))


# K3's tensor-core tiles (bf16 x, M > 8, g a multiple of 32): the m1
# branch (g = 128 at every M, g = 32 at M <= 32) and the fold branch (g = 32,
# M > 32), sym and asym, K = 1280 < Kp = 1536 and ragged N, and the lm_head
# shape N = 32000. Bars as for the other routes: 1e-4 for an f32 output (the
# m1 branch subtracts 136 * s * sum(x_g) in f32), 2e-3 for a bf16 one.
@pytest.mark.parametrize("out_dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("K,N", [(1280, 1001), (4096, 32000)])
@pytest.mark.parametrize("scheme", ["sym", "asym"])
@pytest.mark.parametrize("g", [128, 32])
@pytest.mark.parametrize("M", [9, 16, 33, 512, 2048])
def test_woq_w32_tiles_match_plain(dev, M, g, scheme, K, N, out_dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(M + K + N + g)
    x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
    w = torch.randn(K, N, device=dev, generator=gen) * 0.02
    qt = packing.to_decode_layout(packing.quantize_groupwise(w, "int4", scheme, g))
    got = quant_matmul.woq_w32_cuda(x, qt, out_dtype)
    again = quant_matmul.woq_w32_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_w32_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol
    assert torch.equal(got, again)


# Split tile launches are deterministic (the last block of a tile sums the
# partials in split order): two launches give the same bits, and a CUDA-graph
# replay gives the eager bits once the kernel has run on the capturing
# stream (which makes that stream's tile counters).
@pytest.mark.parametrize("layout", ["khalf", "w32"])
def test_woq_split_tiles_are_deterministic_and_replay_from_a_graph(dev, layout):
    gen = torch.Generator(device=dev).manual_seed(5)
    K, N, M = 4096, 4096 + 128, 16
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, "int4", "sym", 128)
    if layout == "w32":
        qt, fn, span = packing.to_decode_layout(qt), quant_matmul.woq_w32_cuda, K
    else:
        fn, span = quant_matmul.woq_int4_cuda, K // 2
    bm, chunk = quant_matmul.tile_plan(M, N, span, 128, quant_matmul.target_blocks(dev.index))
    assert -(-span // chunk) > 1
    x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
    want = fn(x, qt, torch.bfloat16)
    assert torch.equal(want, fn(x, qt, torch.bfloat16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, qt, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = fn(x, qt, torch.bfloat16)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# K2 against its plain twin, which rounds the same way (bf16(s), exact q - z,
# q·s rounded once to bf16): the two differ only in summation order (split-K
# partials, warps, mma), so f32 outputs hold 1e-5 relative; a bf16 output
# adds one bf16 rounding: 2e-3. bf16 x above the GEMV takes the tensor-core
# tiles, f32 x the SIMT tiles.
@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-3),
])
@pytest.mark.parametrize("scheme,M,K,N,g", [
    ("sym", 1, 4096, 4096, 128),  # GEMV, split K
    ("asym", 8, 1024, 300, 32),  # tiles (SIMT: 16 rows), ragged N
    ("sym", 9, 768, 1000, 32),  # tiles (SIMT: 16 rows), split K
    ("asym", 64, 2048, 512, 128),  # tiles (SIMT: 64 rows)
    ("sym", 513, 1024, 257, 128),  # ragged M and N (byte loads)
    ("sym", 1, 11008, 4096, 128),  # the Llama-2-7B down product
])
def test_woq_int8_kernel_matches_plain(dev, scheme, M, K, N, g, x_dtype, out_dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, device=dev, generator=gen).to(x_dtype)
    w = torch.randn(K, N, device=dev, generator=gen) * 0.05
    qt = packing.quantize_groupwise(w, "int8", scheme, g)
    before = quant_matmul.woq_int8_cuda.launches
    got = quant_matmul.woq_int8_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_matmul_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert quant_matmul.woq_int8_cuda.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("M", [1, 512])
def test_woq_int8_kernel_is_deterministic_and_dispatched(dev, M):
    """Split-K sums in a fixed order: two runs give the same bits (the GEMV
    at M = 1, the tensor-core tiles at M = 512); and `woq_matmul` sends an
    int8 weight at M < 1024 to K2, once."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(M, 4096, device=dev, generator=gen).to(torch.bfloat16)
    qt = packing.quantize_groupwise(torch.randn(4096, 4096, device=dev, generator=gen) * 0.02, "int8", "sym", 128)
    a = quant_matmul.woq_int8_cuda(x, qt, torch.bfloat16)
    b = quant_matmul.woq_int8_cuda(x, qt, torch.bfloat16)
    assert torch.equal(a, b)
    before = (quant_matmul.woq_int8_cuda.launches, quant_matmul.woq_int8_cuda.tile_launches)
    c = quant_matmul.woq_matmul(x, qt)
    assert quant_matmul.woq_int8_cuda.launches == before[0] + 1 and torch.equal(a, c)
    assert quant_matmul.woq_int8_cuda.tile_launches == before[1] + (M > quant_matmul.K2_GEMV_MAX_M)


# K2's split-K GEMV (K1's design) at M = 1 and, with K2_GEMV_MAX_M raised,
# at 2 and 8 rows: 16-byte words (N = 4096), 4-byte (4100), bytes (4097);
# K = 4096 splits into several groups, so the last block of each strip sums
# the partials, and leaves the stream's strip counters at 0. Bars as above.
@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-3),
])
@pytest.mark.parametrize("scheme", ["sym", "asym"])
@pytest.mark.parametrize("N", [4096, 4100, 4097])
@pytest.mark.parametrize("M", [1, 2, 8])
def test_woq_int8_gemv_matches_plain(dev, monkeypatch, M, N, scheme, x_dtype, out_dtype, tol):
    monkeypatch.setattr(quant_matmul, "K2_GEMV_MAX_M", 8)
    K = 4096
    gen = torch.Generator(device=dev).manual_seed(M + N)
    x = torch.randn(M, K, device=dev, generator=gen).to(x_dtype)
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.05, "int8", scheme, 128)
    assert quant_matmul.k2_route(x, M, 128) == "gemv"
    assert -(-K // quant_matmul.gemv_k_chunk(N, K, 128, quant_matmul.target_blocks(dev.index))) > 1
    got = quant_matmul.woq_int8_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_matmul_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol
    assert torch.equal(got, quant_matmul.woq_int8_cuda(x, qt, out_dtype))
    counters = quant_matmul._k1_counters[(dev, torch.cuda.current_stream().cuda_stream, -(-N // 128))]
    assert int(counters.abs().sum()) == 0


# K2's tensor-core tiles (bf16 x, M > K2_GEMV_MAX_M, g a multiple of 32)
# against the same plain twin and bars. K = 1024 is 8 (g 128) or 32 (g 32)
# groups; the plans split K at the small M and N and not at M >= 512 with N
# >= 11008 (`tile_plan`); N = 1000 (not a multiple of 128) takes byte
# copies of the weight, the rest 16-byte copies. Two launches give the same
# bits.
@pytest.mark.parametrize("out_dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("N", [1000, 4096, 11008, 32000])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("scheme", ["sym", "asym"])
@pytest.mark.parametrize("M", [9, 16, 33, 512, 1023])
def test_woq_int8_tiles_match_plain(dev, M, scheme, g, N, out_dtype, tol):
    K = 1024
    gen = torch.Generator(device=dev).manual_seed(M + N + g)
    x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.05, "int8", scheme, g)
    assert quant_matmul.k2_route(x, M, g) == "tiles"
    before = quant_matmul.woq_int8_cuda.tile_launches
    got = quant_matmul.woq_int8_cuda(x, qt, out_dtype)
    again = quant_matmul.woq_int8_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_matmul_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert quant_matmul.woq_int8_cuda.tile_launches == before + 2
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol
    assert torch.equal(got, again)


def test_woq_int8_tile_plans_split_and_unsplit(dev):
    """The tile cases above meet both plans on this card."""
    target = quant_matmul.target_blocks(dev.index)
    assert quant_matmul.tile_plan(9, 4096, 1024, 128, target, quant_matmul.K2_TILE_MAX_BM)[1] < 1024
    assert quant_matmul.tile_plan(1023, 32000, 1024, 32, target, quant_matmul.K2_TILE_MAX_BM)[1] == 1024


# K2's tiles on an x that starts 2 bytes past an aligned address (element
# copies) and at the Llama widths, with g not a multiple of 32 (the SIMT
# tiles) beside.
@pytest.mark.parametrize("M,K,N,g", [(16, 4096, 4096, 128), (333, 4096, 1001, 64), (64, 11008, 4096, 128),
                                     (40, 960, 512, 48)])
def test_woq_int8_tiles_unaligned_x_and_llama_widths(dev, M, K, N, g):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    base = torch.randn(M, K + 1, device=dev, generator=gen).to(torch.bfloat16)
    qt = packing.quantize_groupwise(torch.randn(K, N, device=dev, generator=gen) * 0.02, "int8", "asym", g)
    assert quant_matmul.k2_route(base, M, g) == ("tiles" if g % 32 == 0 else "simt")
    for x in (base[:, :K].contiguous(), base.flatten()[1:M * K + 1].view(M, K)):
        got = quant_matmul.woq_int8_cuda(x, qt, torch.float32)
        want = quant_matmul.woq_matmul_plain(x.contiguous(), qt, torch.float32)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5
        assert torch.equal(got, quant_matmul.woq_int8_cuda(x, qt, torch.float32))


def _scan_top2_matches_plain(q, d, size, n_tile):
    kv, ki = scan_topk.scan_top2_cuda(q, d, size, n_tile)
    pv, pi = scan_topk.scan_top2_plain(q, d, size, n_tile)
    torch.cuda.synchronize()
    kv, ki, pv, pi = (t.cpu().numpy() for t in (kv, ki, pv, pi))
    finite = np.isfinite(pv)
    assert np.array_equal(np.isfinite(kv), finite)
    assert np.abs(kv[finite] - pv[finite]).max() <= 1e-4
    assert ki.max() < size and np.array_equal(ki == -1, ~finite)
    rows, cols = np.nonzero(ki != pi)
    qf = q.to(torch.bfloat16).double().cpu().numpy()
    df = d.to(torch.bfloat16).double().cpu().numpy()
    sk = np.einsum("rd,rd->r", qf[rows], df[ki[rows, cols]])
    sp = np.einsum("rd,rd->r", qf[rows], df[pi[rows, cols]])
    assert np.all(np.abs(sk - sp) <= 1e-4)


# K5 on the tensor cores (bf16 rows, D % 8 == 0, 16-byte aligned; every case
# here) and on the SIMT kernel against the plain version: scores within 1e-4
# absolute (unit rows, f32 sums in another order); where an id differs, the
# two ids' scores are within that bound. B = 70, 129, 300 and 4133 are not
# multiples of the 64 queries a block; sizes 3333, 2500, 1500 and 13500 end
# inside a tile.
@pytest.mark.parametrize("B,N,D,size,n_tile", [
    (64, 4096, 128, 4096, 1024),
    (300, 5000, 384, 3333, 1024),
    (70, 1000, 96, 1000, 256),
    (129, 3000, 768, 2500, 256),
    (4133, 20000, 768, 13500, 1024),
    (200, 2048, 96, 1500, 1024),
])
def test_scan_top2_kernel_matches_plain(dev, B, N, D, size, n_tile):
    gen = torch.Generator(device=dev).manual_seed(B + N)
    q = torch.nn.functional.normalize(torch.randn(B, D, device=dev, generator=gen), dim=1)
    d = torch.nn.functional.normalize(torch.randn(N, D, device=dev, generator=gen), dim=1)
    before = scan_topk.scan_top2_cuda.tile_launches
    _scan_top2_matches_plain(q, d, size, n_tile)
    assert scan_topk.scan_top2_cuda.tile_launches == before + 1


@pytest.mark.parametrize("D,offset", [(100, 0), (768, 1)])
def test_scan_top2_simt_route_matches_plain(dev, D, offset):
    """D % 8 != 0, or bf16 queries one element past an aligned address: the
    SIMT kernel, with the same bars."""
    B, N, size = 150, 3000, 2900
    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.empty(B * D + offset, dtype=torch.bfloat16, device=dev)[offset:].view(B, D)
    q.copy_(torch.nn.functional.normalize(torch.randn(B, D, device=dev, generator=gen), dim=1))
    d = torch.nn.functional.normalize(torch.randn(N, D, device=dev, generator=gen), dim=1)
    assert scan_topk.k5_route(D, q.dtype, q.data_ptr(), 0) == "simt"
    before = (scan_topk.scan_top2_cuda.launches, scan_topk.scan_top2_cuda.tile_launches)
    _scan_top2_matches_plain(q, d, size, 1024)
    assert (scan_topk.scan_top2_cuda.launches, scan_topk.scan_top2_cuda.tile_launches) == (before[0] + 1, before[1])


def test_scan_top2_tensor_cores_ties_go_to_highest_id(dev):
    """Exact duplicate docs score equal on the tensor cores; the higher id
    wins, as in the plain version: each tile's top-2 is one doc's two copies."""
    gen = torch.Generator(device=dev).manual_seed(2)
    docs = torch.randn(512, 128, device=dev, generator=gen).repeat_interleave(2, dim=0)  # ids 2j, 2j + 1 equal
    q = torch.randn(64, 128, device=dev, generator=gen)
    before = scan_topk.scan_top2_cuda.tile_launches
    kv, ki = scan_topk.scan_top2_cuda(q, docs, 1024, 256)
    pv, pi = scan_topk.scan_top2_plain(q, docs, 1024, 256)
    torch.cuda.synchronize()
    assert scan_topk.scan_top2_cuda.tile_launches == before + 1
    assert torch.equal(ki, pi)
    assert bool((ki[:, 0::2] % 2 == 1).all()) and torch.equal(ki[:, 1::2], ki[:, 0::2] - 1)
    assert torch.equal(kv[:, 0::2], kv[:, 1::2])


# K3 against its plain version: both take exact products of x with 128 + v'
# and f32 sums; the m1 branch then subtracts 136 * s * sum(x_g), ~40x the
# result, so f32 rounding in another order reaches a few 1e-5 relative: 1e-4
# bounds it. A bf16 output adds one bf16 rounding: 2e-3.
@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-3),
])
@pytest.mark.parametrize("scheme,M,K,N,g", [
    ("sym", 1, 4096, 4096, 128),  # GEMV, m1
    ("sym", 5, 1280, 300, 64),  # GEMV (M <= 8), K padded to 1536, ragged N
    ("asym", 16, 11008, 512, 128),  # tiled, m1, Kp = 11264
    ("sym", 200, 1024, 1000, 32),  # tiled, fold branch
    ("asym", 48, 1152, 300, 32),  # tiled, fold branch, K padded
])
def test_woq_w32_kernel_matches_plain(dev, scheme, M, K, N, g, x_dtype, out_dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, device=dev, generator=gen).to(x_dtype)
    w = torch.randn(K, N, device=dev, generator=gen) * 0.02
    qt = packing.to_decode_layout(packing.quantize_groupwise(w, "int4", scheme, g))
    got = quant_matmul.woq_w32_cuda(x, qt, out_dtype)
    want = quant_matmul.woq_w32_plain(x, qt, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert _rel(got, want) <= tol


# K4 against the plain f32 attention: unit-normal inputs, f32 scores and
# softmax on both sides in another order, so f32 outputs agree to 1e-5
# absolute; bf16 outputs (tensor cores: bf16 Q, K, V exact, P as a bf16
# pair of ~16 bits, f32 accumulators) to one bf16 rounding (2e-3 relative).
# Two runs give the same bits.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,q_offset", [
    (1, 300, 300, 4, 4, 128, True, 0),
    (2, 200, 200, 8, 2, 64, True, 0),  # GQA
    (1, 64, 500, 4, 4, 80, True, 436),  # chunked prefill offset
    (1, 70, 90, 2, 2, 40, False, 0),  # non-causal, S != T
    (1, 130, 130, 2, 1, 256, True, 0),  # the largest head dim
    (1, 1, 1, 2, 2, 64, True, 0),  # one query, one key
    (1, 1, 700, 4, 4, 128, True, 699),  # T = 1 at the end of a long S
    (1, 63, 63, 4, 4, 72, True, 0),  # T below a tile, D padded to 80
    (1, 1500, 1500, 4, 4, 128, True, 0),  # ragged S
    (1, 256, 256, 32, 8, 128, True, 0),  # GQA 32/8
    (1, 200, 200, 8, 1, 256, True, 0),  # GQA 8/1 at D = 256
    (1, 100, 1500, 4, 4, 64, False, 0),  # non-causal over a long S
])
def test_flash_attention_kernel_matches_plain(dev, B, T, S, H, Hkv, D, causal, q_offset, dtype):
    from intel_extension_for_transformers_tpu_torch.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(T + S + D)
    q = torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(dtype)
    before = flash_attention.flash_attention_cuda.launches
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    again = flash_attention.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_cuda.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert _rel(got, want) <= 2e-3


def test_flash_attention_kernel_rejects_unsupported_head_dim(dev):
    from intel_extension_for_transformers_tpu_torch.ops import flash_attention

    q = torch.randn(1, 8, 2, 12, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_cuda(q, q, q)


def _ivf_storage(dev, C, D, L_pad, fill_rows, bits, seed):
    """Packed IVF lists on the card: `fill_rows` coded residual rows per list
    (-1 ids after them), from the port's own codec."""
    from intel_extension_for_transformers_tpu_torch.retrieval.ivf import _encode_residual

    gen = torch.Generator(device=dev).manual_seed(seed)
    cent = torch.nn.functional.normalize(torch.randn(C, D, generator=gen, device=dev), dim=1)
    v = cent.repeat_interleave(L_pad, 0) + 0.3 * torch.randn(C * L_pad, D, generator=gen, device=dev) / D**0.5
    codes, scales = _encode_residual(v, cent.repeat_interleave(L_pad, 0), 32, bits)
    rid = torch.arange(C * L_pad, device=dev, dtype=torch.int32).reshape(C, L_pad)
    rid[:, fill_rows:] = -1
    return cent, codes.reshape(C, L_pad, -1), scales.reshape(C, L_pad, -1), rid


def _ivf_queries(dev, cent, B, nprobe, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.nn.functional.normalize(
        cent[torch.randint(0, cent.shape[0], (B,), generator=gen, device=dev)]
        + 0.5 * torch.randn(B, cent.shape[1], generator=gen, device=dev) / cent.shape[1] ** 0.5, dim=1)
    probes = torch.topk(q @ cent.T, nprobe, dim=1).indices.to(torch.int32)
    probes[:, -1] = probes[:, 0]  # a repeated probe counts once (K6) / repeats its candidates (K7)
    return q, probes


def _assert_ivf_match(got, want, tol):
    """Scores within tol; ids equal as sets, but for those within tol of the
    plain version's k-th score (a near-tie either side may keep)."""
    (ks, ki), (ps, pi) = [(s.cpu().numpy(), i.cpu().numpy()) for s, i in (got, want)]
    assert np.array_equal(np.isfinite(ks), np.isfinite(ps)) and np.array_equal(ki < 0, pi < 0)
    fin = np.isfinite(ps)
    assert np.abs(ks[fin] - ps[fin]).max(initial=0.0) <= tol
    for rk, sk, rp, sp in zip(ki, ks, pi, ps):
        kth = sp[np.isfinite(sp)].min(initial=np.inf)
        for own, vals, other in ((rk, sk, rp), (rp, sp, rk)):
            for i, v in zip(own.tolist(), vals.tolist()):
                assert i in other.tolist() or v <= kth + tol


# K6 and K7 against their plain versions: both sum exact products of
# bf16(q) and the bf16 residual in f32, in another order, so scores differ
# by at most D·2^-24·Σ|q_i r_i| <= 768 · 6e-8 · 1 ≈ 5e-5 for unit queries
# and residuals of norm <= 1: tolerance 5e-5.
IVF_TOL = 5e-5


@pytest.mark.parametrize("bits,track,mult,offset,k", [
    (8, False, 1, 0, 10),
    (4, False, 1, 0, 10),
    (4, True, 16, 8, 64),  # the refine tier's global top-r
    (8, True, 1, 0, 200),
])
@pytest.mark.parametrize("C,D,L_pad,fill_rows,B,nprobe", [
    (16, 128, 256, 200, 5, 4),
    (64, 768, 1536, 1220, 64, 8),  # the 10M configuration's list shape
])
def test_ivf_scan_topk_kernel_matches_plain(dev, bits, track, mult, offset, k, C, D, L_pad, fill_rows, B, nprobe):
    from intel_extension_for_transformers_tpu_torch.ops import ivf_scan

    cent, packed, scales, rid = _ivf_storage(dev, C, D, L_pad, fill_rows, bits, seed=C + D)
    q, probes = _ivf_queries(dev, cent, B, nprobe, seed=B)
    kw = dict(k=k, bits=bits, group_size=32, l_blk=L_pad, track_positions=track,
              code_mult=mult, code_offset=offset)
    got = ivf_scan.ivf_scan_topk_cuda(q, cent, packed, scales, rid, probes, **kw)
    want = ivf_scan.ivf_scan_topk_plain(q, cent, packed, scales, rid, probes, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (B, k) and got[1].dtype == torch.int32
    _assert_ivf_match(got, want, IVF_TOL)


@pytest.mark.parametrize("bits,mult,offset,t", [(4, 16, 8, 24), (8, 1, 0, 16), (4, 1, 0, 250)])
@pytest.mark.parametrize("C,D,L_pad,fill_rows,B,nprobe", [
    (16, 128, 256, 200, 5, 4),
    (64, 768, 1536, 1220, 64, 8),
])
def test_ivf_scan_candidates_kernel_matches_plain(dev, bits, mult, offset, t, C, D, L_pad, fill_rows, B, nprobe):
    from intel_extension_for_transformers_tpu_torch.ops import ivf_scan

    cent, packed, scales, rid = _ivf_storage(dev, C, D, L_pad, fill_rows, bits, seed=C + D + 1)
    q, probes = _ivf_queries(dev, cent, B, nprobe, seed=B + 1)
    kw = dict(t=t, bits=bits, group_size=32, l_blk=L_pad, code_mult=mult, code_offset=offset)
    gs, gp = ivf_scan.ivf_scan_candidates_cuda(q, cent, packed, scales, rid, probes, **kw)
    ws, wp = ivf_scan.ivf_scan_candidates_plain(q, cent, packed, scales, rid, probes, **kw)
    torch.cuda.synchronize()
    assert gs.shape == (B, nprobe * t)
    _assert_ivf_match((gs.reshape(-1, t), gp.reshape(-1, t)), (ws.reshape(-1, t), wp.reshape(-1, t)), IVF_TOL)


def test_ivf_scan_kernel_rejects_a_shifted_scale_plane(dev):
    """The bar above sees a fault: the scales shifted by one group."""
    from intel_extension_for_transformers_tpu_torch.ops import ivf_scan

    cent, packed, scales, rid = _ivf_storage(dev, 16, 128, 256, 200, 8, seed=3)
    q, probes = _ivf_queries(dev, cent, 8, 4, seed=3)
    kw = dict(k=10, bits=8, group_size=32, l_blk=256)
    got = ivf_scan.ivf_scan_topk_cuda(q, cent, packed, torch.roll(scales, 1, dims=2), rid, probes, **kw)
    want = ivf_scan.ivf_scan_topk_plain(q, cent, packed, scales, rid, probes, **kw)
    with pytest.raises(AssertionError):
        _assert_ivf_match(got, want, IVF_TOL)


def test_ivf_index_kernel_route_matches_materializing_route(dev):
    from intel_extension_for_transformers_tpu_torch.retrieval import IVFIndex, clustered_embeddings_device

    docs, queries = clustered_embeddings_device(40_000, 128, 32, n_topics=32, device=dev)
    # the materializing refine route keeps the global top nprobe·rescore_t = 48, as K6 does at r = 48
    for kw, skw in ((dict(dtype="int8"), {}), (dict(dtype="int4", refine="int8"), {"rescore_r": 48, "rescore_t": 8}),
                    (dict(dtype="int4", refine="int8", refine_capacity=40_000), {"rescore_t": 16})):
        idx = IVFIndex(128, 64, list_cap=800, spill=True, device=dev, **kw)
        idx.train(docs[:8000], iters=4)
        idx.add(docs)
        got = idx.search(queries, k=10, nprobe=6, **skw)
        want = idx.search(queries, k=10, nprobe=6, use_kernel=False, **skw)
        if "rescore_r" not in skw and "refine" in kw:  # K7's per-list quotas select other candidates
            assert (got[1] >= 0).all()
            continue
        _assert_ivf_match([torch.from_numpy(a) for a in got], [torch.from_numpy(a) for a in want], IVF_TOL)
