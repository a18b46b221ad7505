"""Port parity for int8 WOQ: the plain version of K2 (`woq_matmul_plain`, run
on CPU tensors) against the JAX package's `_woq_kernel_8bit` in interpret mode.

Tolerance: 1e-5 relative (Frobenius). Both sides round the dequantized
weight identically (bf16(s), q − z exact, q·s rounded once to bf16; all f32
in f32 compute) and sum exact products in f32, in another order. The JAX
fallback to the f32 reference (`_pick_tiles` gives tk == 0 for K % 128 != 0
beyond 16,384 rows) is not a case here: every shape below takes the kernel
branch, which each test checks by making the fallback raise. The port's K2
takes every shape, so it has no such fallback."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.ops import packing as jpk
from intel_extension_for_transformers_tpu.ops import quant_matmul as jqm
from intel_extension_for_transformers_tpu_torch.ops import packing as tpk
from intel_extension_for_transformers_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

N_RAGGED = 300
KERNEL_REL_TOL = 1e-5
# the dequantize-once branch rounds its output to the compute dtype
ONCE_REL_TOL = {"float32": 1e-5, "bfloat16": 2e-3}


def _operands(M, K, scheme, g, scale_dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N_RAGGED)) * 0.05).astype(np.float32)
    jq = jpk.quantize_groupwise(jnp.asarray(w), "int8", scheme, g, scale_dtype=getattr(jnp, scale_dtype))
    tq = tpk.quantize_groupwise(torch.from_numpy(w), "int8", scheme, g, scale_dtype=getattr(torch, scale_dtype))
    return x, jq, tq


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture
def kernel_branch(monkeypatch):
    """The JAX dispatch must reach `_woq_kernel_8bit`, not its f32 fallback."""
    def no_fallback(*a, **k):
        raise AssertionError("the JAX dispatch fell back to woq_matmul_ref")

    monkeypatch.setattr(jqm, "woq_matmul_ref", no_fallback)


def _check(M, K, scheme, g, scale_dtype, dtype, seed):
    x, jq, tq = _operands(M, K, scheme, g, scale_dtype, seed)
    want = jqm.woq_matmul(jnp.asarray(x).astype(dtype), jq, out_dtype=jnp.float32, interpret=True)
    got = tqm.woq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tq, torch.float32)
    assert got.shape == (M, N_RAGGED) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= KERNEL_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["sym", "asym"])
@pytest.mark.parametrize("M,g,scale_dtype", [
    (1, 128, "float32"), (7, 32, "bfloat16"), (64, 64, "float32"), (300, 128, "bfloat16"),
])
def test_int8_plain_matches_pallas_kernel(kernel_branch, M, g, scale_dtype, scheme, dtype):
    """M in {1, 7, 64, 300} (decode to prefill rows), ragged N = 300, K = 256."""
    _check(M, 256, scheme, g, scale_dtype, dtype, seed=M + g)


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_int8_plain_matches_pallas_kernel_groups(kernel_branch, g, scale_dtype):
    """Every group size and scale dtype, asym bf16 compute (the scale and the
    zero point both round to bf16)."""
    _check(7, 256, "asym", g, scale_dtype, "bfloat16", seed=g)


@pytest.mark.parametrize("g", [32, 128])
def test_int8_plain_matches_pallas_kernel_multi_step(kernel_branch, g):
    """K = 4096: the JAX kernel walks K in two 2048-row steps, slicing scale rows."""
    _check(5, 4096, "sym", g, "float32", "bfloat16", seed=g + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dequantize_once_branch(dtype):
    """M >= 1024: both packages decode the int8 weight once into the compute
    dtype and take one plain matmul, K2 unused."""
    x, jq, tq = _operands(1024, 256, "asym", 64, "float32", seed=9)
    want = jqm.woq_matmul(jnp.asarray(x).astype(dtype), jq)
    got = tqm.woq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tq)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= ONCE_REL_TOL[dtype]


@pytest.mark.parametrize("M,N,K,g", [
    (1, 4096, 4096, 128), (1, 4096, 11008, 128), (1, 32000, 4096, 128), (1, 300, 1024, 32),
    (9, 4096, 4096, 128), (16, 11008, 4096, 32), (33, 1000, 2048, 128), (300, 300, 256, 64),
    (512, 4096, 4096, 128), (1023, 32000, 4096, 128),
])
def test_int8_k_chunk_splits_on_group_boundaries(M, N, K, g):
    """K2's split K over its span of K rows, by `gemv_k_chunk` (the GEMV,
    128-column strips) at M = 1 and `tile_plan` (the tensor-core tiles,
    BM x 128) above: each chunk is whole groups or all of K, the splits
    cover K exactly with none empty, and the blocks reach the target (two
    an SM, 264 on an H100's 132) unless every split is one group."""
    target = 2 * 132
    if M <= tqm.K2_GEMV_MAX_M:
        chunk, blocks = tqm.gemv_k_chunk(N, K, g, target), -(-N // 128)
    else:
        bm, chunk = tqm.tile_plan(M, N, K, g, target, tqm.K2_TILE_MAX_BM)
        assert bm in (16, 32, 64, 128) and bm <= tqm.K2_TILE_MAX_BM and (M <= bm or bm == tqm.K2_TILE_MAX_BM)
        blocks = -(-N // 128) * -(-M // bm)
    splits = -(-K // chunk)
    assert chunk % g == 0 or chunk == K
    assert (splits - 1) * chunk < K <= splits * chunk
    assert blocks * splits >= target or chunk == g or splits == K // g
    assert splits == 1 or blocks < target


def test_int8_k_chunk_values():
    """The GEMV's plan at the Llama-2-7B decode product: 32 strips x 11
    splits of 3 groups (the last of 2), K1's plan; the tiles at M = 512 on 4096 -> 4096 (32 x 4 tiles
    of 128 rows) split in 3 of 11, 11 and 10 groups."""
    assert tqm.gemv_k_chunk(4096, 4096, 128, 2 * 132) == 384
    assert tqm.int4_k_chunk(4096, 8192, 128, 2 * 132) == tqm.gemv_k_chunk(4096, 4096, 128, 2 * 132)
    assert tqm.tile_plan(512, 4096, 4096, 128, 2 * 132, 128) == (128, 11 * 128)
    assert tqm.tile_plan(1023, 32000, 4096, 128, 2 * 132, 128) == (128, 4096)


@pytest.mark.parametrize("dtype,M,g,route", [
    (torch.bfloat16, 1, 128, "gemv"), (torch.float32, 1, 128, "gemv"), (torch.bfloat16, 1, 48, "gemv"),
    (torch.bfloat16, 2, 128, "tiles"), (torch.bfloat16, 9, 32, "tiles"), (torch.bfloat16, 1023, 64, "tiles"),
    (torch.float32, 2, 128, "simt"), (torch.float32, 512, 128, "simt"),
    (torch.bfloat16, 512, 48, "simt"), (torch.bfloat16, 16, 16, "simt"),
])
def test_k2_route(dtype, M, g, route):
    """K2's kernel: the GEMV up to K2_GEMV_MAX_M rows at every dtype and g;
    above it the tensor-core tiles only for bf16 x with g a multiple of 32,
    the SIMT tiles where they cannot run."""
    assert tqm.K2_GEMV_MAX_M == 1
    assert tqm.k2_route(torch.empty(0, dtype=dtype), M, g) == route


def test_int8_on_a_cpu_tensor_never_launches_k2():
    x, _, tq = _operands(3, 256, "sym", 64, "float32", seed=2)
    before = tqm.woq_int8_cuda.launches
    tqm.woq_matmul(torch.from_numpy(x), tq)
    assert tqm.woq_int8_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        tqm.woq_int8_cuda(torch.from_numpy(x), tq, torch.float32)
