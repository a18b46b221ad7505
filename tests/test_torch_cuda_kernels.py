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
