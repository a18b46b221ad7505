"""Port parity for the whole retrieval slice: parse → chunk → INT4 encode →
int4 flat index → rerank → QA prompt, on a small corpus, with the JAX
package's tiny INT4 encoder and reranker carried over by the bridge.

The JAX index runs its accelerator branch (`_use_pallas` patched to True,
Pallas in interpret mode), and the port's index is given the JAX rotation,
so both sides score the same codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import tree_to_numpy

from intel_extension_for_transformers_tpu.models import bert as jbert
from intel_extension_for_transformers_tpu.quantization import RtnConfig as JRtn
from intel_extension_for_transformers_tpu.quantization import quantize_model as jquantize
from intel_extension_for_transformers_tpu.retrieval import index as jindex
from intel_extension_for_transformers_tpu.retrieval.agent import RetrievalAgent as JAgent
from intel_extension_for_transformers_tpu.retrieval.embedder import TextEmbedder as JEmbedder
from intel_extension_for_transformers_tpu.retrieval.reranker import (
    CrossEncoderReranker as JReranker,
)
from intel_extension_for_transformers_tpu_torch import bridge
from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig
from intel_extension_for_transformers_tpu_torch.retrieval import index as tindex
from intel_extension_for_transformers_tpu_torch.retrieval.agent import RetrievalAgent
from intel_extension_for_transformers_tpu_torch.retrieval.embedder import TextEmbedder
from intel_extension_for_transformers_tpu_torch.retrieval.reranker import CrossEncoderReranker

torch.set_num_threads(1)

JCONFIG = jbert.BertConfig.tiny(num_hidden_layers=2)
TCONFIG = BertConfig.tiny(num_hidden_layers=2)
QUERIES = ["how are int4 weights packed", "what does the reranker score"]
TOPICS = [
    "int4 weights pack two values per byte with group scales",
    "the flat index scans packed codes and rescores a shadow copy",
    "a cross encoder reranker scores each query and passage pair",
    "documents are parsed then split into overlapping chunks",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    words = " ".join(TOPICS).split()
    for i, topic in enumerate(TOPICS):
        paras = [
            f"{topic}. " + " ".join(rng.choice(words, size=40)) + "." for _ in range(6)
        ]
        ext = "md" if i % 2 else "txt"
        (root / f"doc{i}.{ext}").write_text(f"# Doc {i}\n\n" + "\n\n".join(paras))
    return str(root)


def _jax_models():
    enc = jbert.bert_init_params(jax.random.PRNGKey(0), JCONFIG)
    rer = jbert.bert_init_params(jax.random.PRNGKey(1), JCONFIG)
    rer["classifier"] = {
        "kernel": jax.random.normal(jax.random.PRNGKey(2), (JCONFIG.hidden_size, 1)) * 0.02,
        "bias": jnp.zeros((1,)),
    }
    cfg = JRtn(weight_dtype="int4", group_size=64)
    return jquantize(enc, cfg).params, jquantize(rer, cfg).params


@pytest.fixture(scope="module")
def agents(corpus):
    mp = pytest.MonkeyPatch()
    mp.setattr(jindex, "_use_pallas", lambda: True)
    jrot = np.asarray(jindex.random_rotation(JCONFIG.hidden_size, 0))
    mp.setattr(tindex, "random_rotation", lambda dim, seed=0: torch.from_numpy(jrot.copy()))
    enc, rer = _jax_models()
    jagent = JAgent(
        JEmbedder(enc, JCONFIG), index_dtype="int4",
        reranker=JReranker(rer, JCONFIG), top_k=4, rerank_top_n=3,
    )
    tagent = RetrievalAgent(
        TextEmbedder(bridge.params_from_numpy(tree_to_numpy(enc), TCONFIG, device="cpu"), TCONFIG),
        index_dtype="int4",
        reranker=CrossEncoderReranker(
            bridge.params_from_numpy(tree_to_numpy(rer), TCONFIG, device="cpu"), TCONFIG
        ),
        top_k=4, rerank_top_n=3,
    )
    jagent.create(corpus)
    tagent.create(corpus)
    yield jagent, tagent
    mp.undo()


def test_chunks_identical(agents):
    """Tolerance: none. Same chunk texts and metadata, in the same order."""
    jagent, tagent = agents
    assert len(tagent.docs) > 8
    assert tagent.docs == jagent.docs


@pytest.mark.parametrize("query", QUERIES)
def test_context_and_prompt_identical(agents, query):
    """The retrieved chunks before rerank are the same set (near-ties at the
    4th score within 1e-4 excepted), the reranked hits the same list with
    scores within 1e-4, and the QA prompt the same string."""
    jagent, tagent = agents
    jq = jagent.embedder.encode([query], is_query=True)
    tq = tagent.embedder.encode([query], is_query=True)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-5)
    js, ji = jagent.index.search(jq, k=4)
    ts, ti = tagent.index.search(tq, k=4)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    kth = js[0].min()
    assert {i for i, s in zip(ji[0], js[0]) if s > kth + 1e-4} <= set(ti[0].tolist())

    jhits, thits = jagent.get_context(query), tagent.get_context(query)
    assert [h["content"] for h in thits] == [h["content"] for h in jhits]
    for jh, th in zip(jhits, thits):
        for key in ("score", "relevance_score"):
            assert abs(th["metadata"][key] - jh["metadata"][key]) <= 1e-4
    assert tagent.pre_llm_inference_actions(query) == jagent.pre_llm_inference_actions(query)
