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
