"""The port stands alone: importing it loads neither jax nor the JAX package,
and the CUDA probe refuses a host without a Hopper card."""

import subprocess
import sys

import pytest
import torch

from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda

torch.set_num_threads(1)

SLICE_MODULES = [
    "intel_extension_for_transformers_tpu_torch",
    "intel_extension_for_transformers_tpu_torch.bridge",
    "intel_extension_for_transformers_tpu_torch.evaluation",
    "intel_extension_for_transformers_tpu_torch.evaluation.harness",
    "intel_extension_for_transformers_tpu_torch.models.bert",
    "intel_extension_for_transformers_tpu_torch.models.generation",
    "intel_extension_for_transformers_tpu_torch.models.llama",
    "intel_extension_for_transformers_tpu_torch.models.registry",
    "intel_extension_for_transformers_tpu_torch.models.tokenization",
    "intel_extension_for_transformers_tpu_torch.neural_chat",
    "intel_extension_for_transformers_tpu_torch.neural_chat.adapters",
    "intel_extension_for_transformers_tpu_torch.neural_chat.base_model",
    "intel_extension_for_transformers_tpu_torch.neural_chat.chatbot",
    "intel_extension_for_transformers_tpu_torch.neural_chat.config",
    "intel_extension_for_transformers_tpu_torch.neural_chat.plugins",
    "intel_extension_for_transformers_tpu_torch.neural_chat.prompts",
    "intel_extension_for_transformers_tpu_torch.ops",
    "intel_extension_for_transformers_tpu_torch.ops.codebooks",
    "intel_extension_for_transformers_tpu_torch.ops.flash_attention",
    "intel_extension_for_transformers_tpu_torch.ops.kernels",
    "intel_extension_for_transformers_tpu_torch.ops.layers",
    "intel_extension_for_transformers_tpu_torch.ops.packing",
    "intel_extension_for_transformers_tpu_torch.ops.quant_matmul",
    "intel_extension_for_transformers_tpu_torch.ops.scan_topk",
    "intel_extension_for_transformers_tpu_torch.quantization",
    "intel_extension_for_transformers_tpu_torch.retrieval",
    "intel_extension_for_transformers_tpu_torch.retrieval.agent",
    "intel_extension_for_transformers_tpu_torch.retrieval.embedder",
    "intel_extension_for_transformers_tpu_torch.retrieval.index",
    "intel_extension_for_transformers_tpu_torch.retrieval.parser",
    "intel_extension_for_transformers_tpu_torch.retrieval.reranker",
    "intel_extension_for_transformers_tpu_torch.retrieval.splitter",
    "intel_extension_for_transformers_tpu_torch.retrieval.synthetic",
    "intel_extension_for_transformers_tpu_torch.utils.device",
    "intel_extension_for_transformers_tpu_torch.utils.error_utils",
    "intel_extension_for_transformers_tpu_torch.utils.errorcode",
    "intel_extension_for_transformers_tpu_torch.utils.profile_llama",
]


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('intel_extension_for_transformers_tpu.')\n"
        "             or m == 'intel_extension_for_transformers_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda()


def test_profile_llama_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from intel_extension_for_transformers_tpu_torch.utils import profile_llama

    assert profile_llama.main() == 1
