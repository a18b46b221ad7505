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


def test_int8_k_chunk_splits_on_group_boundaries():
    """K2's split-K: GEMV splits on group boundaries, tiles on 32-row steps,
    none where the tiles alone give two blocks an SM; no split is empty."""
    for M, N, K, g in ((1, 4096, 4096, 128), (1, 4096, 11008, 128), (8, 300, 1024, 32),
                       (16, 4096, 4096, 128), (300, 300, 256, 64), (512, 4096, 4096, 128)):
        chunk = tqm.int8_k_chunk(M, N, K, g)
        splits = -(-K // chunk)
        assert chunk % (g if M <= tqm.K2_GEMV_MAX_M else 32) == 0 or chunk == K
        assert (splits - 1) * chunk < K
    assert tqm.int8_k_chunk(1, 4096, 4096, 128) == 512  # 32 column strips x 8 splits
    assert tqm.int8_k_chunk(512, 4096, 4096, 128) == 4096  # 512 tiles: no split


def test_int8_on_a_cpu_tensor_never_launches_k2():
    x, _, tq = _operands(3, 256, "sym", 64, "float32", seed=2)
    before = tqm.woq_int8_cuda.launches
    tqm.woq_matmul(torch.from_numpy(x), tq)
    assert tqm.woq_int8_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        tqm.woq_int8_cuda(torch.from_numpy(x), tq, torch.float32)
