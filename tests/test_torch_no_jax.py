"""The port stands alone: importing it loads neither jax, nor the JAX package,
nor HF transformers; the CUDA probe refuses a host without a Hopper card,
and the entry points that take a device run on the card unless the caller
names the CPU."""

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
    "intel_extension_for_transformers_tpu_torch.models",
    "intel_extension_for_transformers_tpu_torch.models.auto",
    "intel_extension_for_transformers_tpu_torch.models.bert",
    "intel_extension_for_transformers_tpu_torch.models.engine",
    "intel_extension_for_transformers_tpu_torch.models.generation",
    "intel_extension_for_transformers_tpu_torch.models.hf_convert",
    "intel_extension_for_transformers_tpu_torch.models.kv_policies",
    "intel_extension_for_transformers_tpu_torch.models.llama",
    "intel_extension_for_transformers_tpu_torch.models.registry",
    "intel_extension_for_transformers_tpu_torch.models.speculative",
    "intel_extension_for_transformers_tpu_torch.models.tokenization",
    "intel_extension_for_transformers_tpu_torch.native",
    "intel_extension_for_transformers_tpu_torch.neural_chat",
    "intel_extension_for_transformers_tpu_torch.neural_chat.adapters",
    "intel_extension_for_transformers_tpu_torch.neural_chat.base_model",
    "intel_extension_for_transformers_tpu_torch.neural_chat.chat_plugins",
    "intel_extension_for_transformers_tpu_torch.neural_chat.chatbot",
    "intel_extension_for_transformers_tpu_torch.neural_chat.config",
    "intel_extension_for_transformers_tpu_torch.neural_chat.plugins",
    "intel_extension_for_transformers_tpu_torch.neural_chat.prompts",
    "intel_extension_for_transformers_tpu_torch.neural_chat.server",
    "intel_extension_for_transformers_tpu_torch.neural_chat.server.neuralchat_client",
    "intel_extension_for_transformers_tpu_torch.neural_chat.server.neuralchat_server",
    "intel_extension_for_transformers_tpu_torch.neural_chat.server.openai_protocol",
    "intel_extension_for_transformers_tpu_torch.ops",
    "intel_extension_for_transformers_tpu_torch.ops.codebooks",
    "intel_extension_for_transformers_tpu_torch.ops.flash_attention",
    "intel_extension_for_transformers_tpu_torch.ops.ivf_scan",
    "intel_extension_for_transformers_tpu_torch.ops.kernels",
    "intel_extension_for_transformers_tpu_torch.ops.layers",
    "intel_extension_for_transformers_tpu_torch.ops.packing",
    "intel_extension_for_transformers_tpu_torch.ops.quant_matmul",
    "intel_extension_for_transformers_tpu_torch.ops.scan_topk",
    "intel_extension_for_transformers_tpu_torch.quantization",
    "intel_extension_for_transformers_tpu_torch.quantization.config",
    "intel_extension_for_transformers_tpu_torch.quantization.quantize",
    "intel_extension_for_transformers_tpu_torch.quantization.save_load",
    "intel_extension_for_transformers_tpu_torch.retrieval",
    "intel_extension_for_transformers_tpu_torch.retrieval._kmeans",
    "intel_extension_for_transformers_tpu_torch.retrieval.agent",
    "intel_extension_for_transformers_tpu_torch.retrieval.bm25",
    "intel_extension_for_transformers_tpu_torch.retrieval.child_parent",
    "intel_extension_for_transformers_tpu_torch.retrieval.embedder",
    "intel_extension_for_transformers_tpu_torch.retrieval.index",
    "intel_extension_for_transformers_tpu_torch.retrieval.ivf",
    "intel_extension_for_transformers_tpu_torch.retrieval.parser",
    "intel_extension_for_transformers_tpu_torch.retrieval.reranker",
    "intel_extension_for_transformers_tpu_torch.retrieval.splitter",
    "intel_extension_for_transformers_tpu_torch.retrieval.synthetic",
    "intel_extension_for_transformers_tpu_torch.transformers",
    "intel_extension_for_transformers_tpu_torch.utils.device",
    "intel_extension_for_transformers_tpu_torch.utils.error_utils",
    "intel_extension_for_transformers_tpu_torch.utils.errorcode",
    "intel_extension_for_transformers_tpu_torch.utils.profile_ivf",
    "intel_extension_for_transformers_tpu_torch.utils.profile_llama",
]


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'transformers')\n"
        "             or m.startswith(('jax.', 'transformers.'))\n"
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


@pytest.mark.parametrize("name", ["profile_llama", "profile_ivf"])
def test_profile_scripts_refuse_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    import importlib

    assert importlib.import_module(f"intel_extension_for_transformers_tpu_torch.utils.{name}").main() == 1


def _entry_points(tmp=None):
    """(name, call with no device) for each entry point that takes one; the
    model API's loaders read a low-bit directory written under `tmp`."""
    import json
    import os
    import types

    import numpy as np

    from intel_extension_for_transformers_tpu_torch import bridge
    from intel_extension_for_transformers_tpu_torch.models import auto, hf_convert
    from intel_extension_for_transformers_tpu_torch.models.engine import DecodeEngine
    from intel_extension_for_transformers_tpu_torch.models.tokenization import ByteTokenizer
    from intel_extension_for_transformers_tpu_torch.neural_chat.chat_plugins import ChatCache
    from intel_extension_for_transformers_tpu_torch.neural_chat.server import NeuralChatServerExecutor
    from intel_extension_for_transformers_tpu_torch.quantization import save_load
    from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig
    from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig
    from intel_extension_for_transformers_tpu_torch.retrieval import (
        FlatIndex,
        IVFIndex,
        clustered_embeddings_device,
    )

    flat_meta = {"dim": 8, "dtype": "float32", "metric": "ip", "size": 1}
    flat_arrays = {"vectors": np.zeros((1, 8), np.float32)}
    ivf_meta = {"dim": 8, "n_lists": 1, "metric": "ip", "dtype": "float32", "list_cap": 8, "size": 0}
    ivf_arrays = {"centroids": np.zeros((1, 8), np.float32), "storage": np.zeros((8, 8), np.float32),
                  "row_ids": np.full(8, -1, np.int32), "fill": np.zeros(1, np.int32)}
    def low_bit_dir():
        with open(os.path.join(tmp, auto.MODEL_CONFIG_NAME), "w") as f:
            json.dump({"model_type": "llama", "config": {}}, f)
        return str(tmp)

    hf_model = types.SimpleNamespace(config=types.SimpleNamespace(model_type="llama"))
    tiny = LlamaConfig.tiny()
    chat_model = torch.nn.Linear(1, 1)  # what the engine and the executor hold: never reached
    server_config = {"port": 0, "loading_config": {"preloaded": (chat_model, tiny, ByteTokenizer())},
                     "serving_config": {"continuous_batching": True}}
    return {
        "AutoModelForCausalLM.from_hf_model": lambda: auto.AutoModelForCausalLM.from_hf_model(hf_model),
        "AutoModelForCausalLM.from_pretrained(dir)": lambda: auto.AutoModelForCausalLM.from_pretrained(low_bit_dir()),
        "AutoModelForCausalLM.load_low_bit": lambda: auto.AutoModelForCausalLM.load_low_bit(low_bit_dir()),
        "AutoModel.from_hf_model": lambda: auto.AutoModel.from_hf_model(hf_model),
        "OptimizedModel.from_pretrained": lambda: auto.OptimizedModel.from_pretrained(low_bit_dir()),
        "hf_convert.llama_params_from_hf": lambda: hf_convert.llama_params_from_hf(hf_model),
        "hf_convert.bert_params_from_hf": lambda: hf_convert.bert_params_from_hf(hf_model),
        "save_load.load_low_bit": lambda: save_load.load_low_bit(low_bit_dir(), LlamaConfig.tiny()),
        "ChatCache": lambda: ChatCache(),
        "FlatIndex": lambda: FlatIndex(64),
        "FlatIndex.from_state": lambda: FlatIndex.from_state(flat_meta, flat_arrays),
        "IVFIndex": lambda: IVFIndex(64),
        "IVFIndex.from_state": lambda: IVFIndex.from_state(ivf_meta, ivf_arrays),
        "bridge.flat_index_state": lambda: bridge.flat_index_state(flat_meta, flat_arrays),
        "bridge.ivf_index_state": lambda: bridge.ivf_index_state(ivf_meta, ivf_arrays),
        "bridge.params_from_numpy": lambda: bridge.params_from_numpy({}, BertConfig.tiny()),
        "bridge.llama_from_numpy": lambda: bridge.llama_from_numpy({}, LlamaConfig.tiny()),
        "clustered_embeddings_device": lambda: clustered_embeddings_device(16, 8, 2),
        "DecodeEngine": lambda: DecodeEngine(chat_model, tiny),
        "NeuralChatServerExecutor.init": lambda: NeuralChatServerExecutor().init(server_config),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name, tmp_path):
    """With no device given, an entry point asks for the card and raises on
    a host without one; it never builds quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tmp_path)[name]()


def test_entry_points_take_the_cpu_when_asked(tmp_path):
    from intel_extension_for_transformers_tpu_torch.retrieval import FlatIndex, IVFIndex

    flat = FlatIndex(8, "float32", device="cpu")
    flat.add(torch.eye(8))
    flat.save(str(tmp_path / "flat"))
    assert FlatIndex.load(str(tmp_path / "flat"), device="cpu").device.type == "cpu"
    assert IVFIndex(8, device="cpu").device.type == "cpu"
