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


# K2 against its plain twin, which rounds the same way (bf16(s), exact q - z,
# q·s rounded once to bf16): the two differ only in summation order (split-K
# partials, warps), so f32 outputs hold 1e-5 relative; a bf16 output adds
# one bf16 rounding: 2e-3.
@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-3),
])
@pytest.mark.parametrize("scheme,M,K,N,g", [
    ("sym", 1, 4096, 4096, 128),  # GEMV, split K
    ("asym", 8, 1024, 300, 32),  # GEMV, 8 rows, ragged N
    ("sym", 9, 768, 1000, 32),  # tiles of 16 rows, split K
    ("asym", 64, 2048, 512, 128),  # tiles of 64 rows
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


def test_woq_int8_kernel_is_deterministic_and_dispatched(dev):
    """Split-K sums in a fixed order: two runs give the same bits; and
    `woq_matmul` sends an int8 weight at M < 1024 to K2."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, 4096, device=dev, generator=gen).to(torch.bfloat16)
    qt = packing.quantize_groupwise(torch.randn(4096, 4096, device=dev, generator=gen) * 0.02, "int8", "sym", 128)
    a = quant_matmul.woq_int8_cuda(x, qt, torch.bfloat16)
    b = quant_matmul.woq_int8_cuda(x, qt, torch.bfloat16)
    assert torch.equal(a, b)
    before = quant_matmul.woq_int8_cuda.launches
    c = quant_matmul.woq_matmul(x, qt)
    assert quant_matmul.woq_int8_cuda.launches == before + 1 and torch.equal(a, c)


@pytest.mark.parametrize("B,N,D,size,n_tile", [
    (64, 4096, 128, 4096, 1024),
    (300, 5000, 384, 3333, 1024),
    (70, 1000, 96, 1000, 256),
])
def test_scan_top2_kernel_matches_plain(dev, B, N, D, size, n_tile):
    """Scores within 1e-4 absolute (unit rows, f32 sums in another order);
    where an id differs, the two ids' scores are within that bound."""
    gen = torch.Generator(device=dev).manual_seed(B + N)
    q = torch.nn.functional.normalize(torch.randn(B, D, device=dev, generator=gen), dim=1)
    d = torch.nn.functional.normalize(torch.randn(N, D, device=dev, generator=gen), dim=1)
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
# absolute; bf16 outputs to one bf16 rounding (2e-3 relative).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Hkv,D,causal,q_offset", [
    (1, 300, 300, 4, 4, 128, True, 0),
    (2, 200, 200, 8, 2, 64, True, 0),  # GQA
    (1, 64, 500, 4, 4, 80, True, 436),  # chunked prefill offset
    (1, 70, 90, 2, 2, 40, False, 0),  # non-causal, S != T
    (1, 130, 130, 2, 1, 256, True, 0),  # the largest head dim
])
def test_flash_attention_kernel_matches_plain(dev, B, T, S, H, Hkv, D, causal, q_offset, dtype):
    from intel_extension_for_transformers_tpu_torch.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(T + S + D)
    q = torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(dtype)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
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
