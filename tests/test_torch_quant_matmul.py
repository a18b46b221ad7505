"""Port parity: WOQ matmul against the JAX package's, whose K1 Pallas kernel
(_woq_kernel_4bit) runs here in interpret mode. On a CPU tensor the port runs
K1's plain version, which rounds the dequantized weight as the kernel does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.ops import packing as jpk
from intel_extension_for_transformers_tpu.ops import quant_matmul as jqm
from intel_extension_for_transformers_tpu_torch.ops import packing as tpk
from intel_extension_for_transformers_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

K, N_RAGGED, G = 256, 300, 64
# Relative Frobenius error. f32 compute is full f32 on both sides: only the
# summation order differs. In bf16 both sides round x and the dequantized
# weight to bf16 at the same places and sum in f32, so the kernel parity test
# holds bf16 to the f32 bound too; the dequantize-once branch rounds its
# output to bf16, so it gets the 2e-3 bound that the WOQ kernel's bf16 checks
# use.
REL_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
KERNEL_REL_TOL = 1e-5


def _operands(M, weight_dtype, scheme, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N_RAGGED)) * 0.05).astype(np.float32)
    jq = jpk.quantize_groupwise(jnp.asarray(w), weight_dtype, scheme, G)
    tq = tpk.quantize_groupwise(torch.from_numpy(w), weight_dtype, scheme, G)
    return x, jq, tq


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 7, 64])
@pytest.mark.parametrize("weight_dtype,scheme", [("int4", "sym"), ("int4", "asym"), ("nf4", "sym")])
def test_woq_matmul_matches_pallas_kernel(weight_dtype, scheme, M, dtype):
    x, jq, tq = _operands(M, weight_dtype, scheme, seed=M)
    want = jqm.woq_matmul(
        jnp.asarray(x).astype(dtype), jq, out_dtype=jnp.float32, interpret=True
    )
    got = tqm.woq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tq, torch.float32)
    assert got.shape == (M, N_RAGGED) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= KERNEL_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["sym", "asym"])
def test_int8_plain_path_matches_pallas_kernel(scheme, dtype):
    """int8 weights run K2's plain version on the CPU, which rounds as the
    JAX package's _woq_kernel_8bit does (more int8 cases:
    test_torch_woq_int8.py)."""
    x, jq, tq = _operands(7, "int8", scheme, seed=8)
    want = jqm.woq_matmul(jnp.asarray(x).astype(dtype), jq, out_dtype=jnp.float32, interpret=True)
    got = tqm.woq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tq, torch.float32)
    assert _rel(got.numpy(), np.asarray(want)) <= KERNEL_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_woq_matmul_dequantize_once_branch(dtype):
    """M >= 1024: both packages decode the weight once into the compute dtype."""
    x, jq, tq = _operands(1024, "int4", "sym", seed=3)
    want = jqm.woq_matmul(jnp.asarray(x).astype(dtype), jq)
    got = tqm.woq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tq)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= REL_TOL[dtype]


def test_woq_linear_bias_and_batch_dims():
    """Tolerance: f32, 1e-5 relative. Leading batch dims and the bias."""
    x, jq, tq = _operands(6, "int4", "sym", seed=4)
    bias = np.random.default_rng(5).normal(size=(N_RAGGED,)).astype(np.float32)
    want = jqm.woq_linear(jnp.asarray(x).reshape(2, 3, K), jq, jnp.asarray(bias))
    got = tqm.woq_linear(torch.from_numpy(x).reshape(2, 3, K), tq, torch.from_numpy(bias))
    assert got.shape == (2, 3, N_RAGGED)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def test_woq_matmul_ref_matches_jax_ref():
    """Tolerance: f32, 1e-5 relative. The f32 oracles agree."""
    x, jq, tq = _operands(5, "int4", "asym", seed=6)
    want = jqm.woq_matmul_ref(jnp.asarray(x), jq)
    got = tqm.woq_matmul_ref(torch.from_numpy(x), tq)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


H100_BLOCKS = 2 * 132  # `target_blocks` on an H100 SXM: two blocks for each of its 132 SMs


@pytest.mark.parametrize("N,K,g", [
    (4096, 4096, 128), (11008, 4096, 128), (4096, 11008, 128),  # the Llama-2-7B decode products
    (768, 768, 128), (300, 256, 64), (1001, 4096, 64), (100_000, 768, 64),
])
def test_int4_k_chunk_splits_on_group_boundaries(N, K, g):
    """K1's split-K GEMV: K/2 splits on group boundaries (one low-plane and
    one high-plane group a unit), covers K/2 with no empty split, and splits
    until the 128-column strips reach two blocks an SM or every split is one
    group."""
    K2 = K // 2
    chunk = tqm.int4_k_chunk(N, K, g, H100_BLOCKS)
    splits = -(-K2 // chunk)
    assert chunk % g == 0 and 0 < chunk <= K2
    assert (splits - 1) * chunk < K2 <= splits * chunk
    strips = -(-N // 128)
    assert strips * splits >= H100_BLOCKS or splits == K2 // g
    assert splits == 1 or chunk == g or strips * splits < 2 * H100_BLOCKS  # no more than it takes


def test_int4_k_chunk_llama_plans():
    assert tqm.int4_k_chunk(4096, 4096, 128, H100_BLOCKS) == 128  # 32 strips x 16 splits
    assert tqm.int4_k_chunk(11008, 4096, 128, H100_BLOCKS) == 512  # 86 strips x 4 splits
    assert tqm.int4_k_chunk(4096, 11008, 128, H100_BLOCKS) == 512  # 32 strips x 11 splits
    assert tqm.int4_k_chunk(4096, 256, 128, H100_BLOCKS) == 128  # one group: one split
    assert tqm.int4_k_chunk(100_000, 768, 64, H100_BLOCKS) == 384  # 782 strips: no split


def test_int4_on_a_cpu_tensor_never_launches_k1():
    x, _, tq = _operands(3, "int4", "sym", seed=4)
    before = tqm.woq_int4_cuda.launches
    tqm.woq_matmul(torch.from_numpy(x), tq)
    assert tqm.woq_int4_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        tqm.woq_int4_cuda(torch.from_numpy(x), tq, torch.float32)


# The tensor-core tile planner of K1 and K3 (csrc/woq_tc.cuh): the walk is
# K/2 packed rows for K1 and K rounded up to g for K3.
@pytest.mark.parametrize("M,N,span,g", [
    (16, 4096, 2048, 128), (16, 11008, 2048, 128), (16, 4096, 5504, 128),  # K1, Llama at M = 16
    (16, 4096, 4096, 128), (16, 11008, 4096, 128), (16, 4096, 11008, 128),  # K3, Llama at M = 16
    (512, 4096, 2048, 128), (2048, 4096, 4096, 128), (2048, 32000, 4096, 128),
    (9, 300, 128, 32), (33, 1001, 640, 64), (1023, 4096, 2048, 32), (16, 100_000, 384, 64),
])
def test_tile_plan_splits_on_group_boundaries(M, N, span, g):
    """Splits fall on group boundaries, cover the walk with no empty split,
    and reach two blocks an SM or one group a split; no more splits than it
    takes."""
    bm, chunk = tqm.tile_plan(M, N, span, g, H100_BLOCKS)
    splits = -(-span // chunk)
    assert chunk % g == 0 and 0 < chunk <= span
    assert (splits - 1) * chunk < span <= splits * chunk
    tiles = -(-N // 128) * -(-M // bm)
    assert tiles * splits >= H100_BLOCKS or splits == -(-span // g)
    # no more splits than it takes: no chunk that gives fewer splits reaches the target
    units = -(-span // g)
    fewer = [-(-units // c) for c in range(1, units + 1) if -(-units // c) < splits]
    assert all(tiles * n < H100_BLOCKS for n in fewer)


def test_tile_plan_llama_plans():
    assert tqm.tile_plan(16, 4096, 2048, 128, H100_BLOCKS) == (16, 128)  # K1 qkvo: 32 tiles x 16 splits
    assert tqm.tile_plan(16, 11008, 2048, 128, H100_BLOCKS) == (16, 512)  # K1 gate/up: 86 tiles x 4
    assert tqm.tile_plan(16, 4096, 5504, 128, H100_BLOCKS) == (16, 640)  # K1 down: 32 tiles x 9
    assert tqm.tile_plan(16, 4096, 4096, 128, H100_BLOCKS) == (16, 384)  # K3 qkvo: 32 tiles x 11
    assert tqm.tile_plan(2048, 4096, 4096, 128, H100_BLOCKS) == (128, 4096)  # scoring: 512 tiles, no split
    assert tqm.tile_plan(2048, 32000, 4096, 128, H100_BLOCKS) == (128, 4096)
    assert tqm.tile_plan(16, 100_000, 384, 64, H100_BLOCKS) == (16, 384)  # index scan: 782 tiles


@pytest.mark.parametrize("M,bm", [(9, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64), (65, 128),
                                  (333, 128), (2048, 128)])
def test_tile_bm_is_picked_from_m(M, bm):
    assert tqm.tile_bm(M) == bm
    assert tqm.tile_plan(M, 4096, 4096, 128, H100_BLOCKS)[0] == bm
    assert tqm.tile_plan(M, 4096, 4096, 128, H100_BLOCKS, tqm.K1_TILE_MAX_BM)[0] == min(bm, 64)  # K1's cap


def test_tile_route_takes_bf16_above_the_gemv():
    x = torch.zeros(16, 256, dtype=torch.bfloat16)
    assert tqm._tile_route(x, 16, 128, tqm.K1_GEMV_MAX_M)
    assert tqm._tile_route(x, 16, 32, tqm.K3_GEMV_MAX_M)
    assert not tqm._tile_route(x, tqm.K1_GEMV_MAX_M, 128, tqm.K1_GEMV_MAX_M)  # the GEMV's rows
    assert not tqm._tile_route(x, 16, 16, tqm.K3_GEMV_MAX_M)  # g not a multiple of 32: SIMT tiles
    assert not tqm._tile_route(x.float(), 16, 128, tqm.K1_GEMV_MAX_M)  # f32 x: SIMT tiles


def test_k1_route_by_m_dtype_and_group():
    xb, xf = torch.zeros(16, 256, dtype=torch.bfloat16), torch.zeros(16, 256)
    assert tqm.k1_route(xb, 1, 128) == tqm.k1_route(xf, 1, 128) == "gemv"  # M <= K1_GEMV_MAX_M = 1
    assert tqm.k1_route(xb, 2, 128) == tqm.k1_route(xb, 1023, 64) == "tiles"
    assert tqm.k1_route(xf, 16, 128) == "simt"  # f32 x: SIMT tiles
    assert tqm.k1_route(xb, 16, 16) == "simt"  # g not a multiple of 32: SIMT tiles


def test_w32_on_a_cpu_tensor_never_launches_k3():
    x, _, tq = _operands(16, "int4", "sym", seed=5)
    w32 = tpk.to_decode_layout(tq)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    before = tqm.woq_w32_cuda.launches
    out = tqm.woq_matmul(xb, w32)
    assert tqm.woq_w32_cuda.launches == before and out.shape == (16, N_RAGGED)
    with pytest.raises(ValueError, match="CUDA device"):
        tqm.woq_w32_cuda(xb, w32, torch.bfloat16)
