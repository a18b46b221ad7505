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
