from intel_extension_for_transformers_tpu_torch.retrieval.agent import RetrievalAgent
from intel_extension_for_transformers_tpu_torch.retrieval.embedder import (
    SimpleTokenizer,
    TextEmbedder,
)
from intel_extension_for_transformers_tpu_torch.retrieval.index import FlatIndex
from intel_extension_for_transformers_tpu_torch.retrieval.parser import DocumentParser
from intel_extension_for_transformers_tpu_torch.retrieval.reranker import (
    CrossEncoder,
    CrossEncoderReranker,
)
from intel_extension_for_transformers_tpu_torch.retrieval.splitter import (
    RecursiveCharacterTextSplitter,
)
from intel_extension_for_transformers_tpu_torch.retrieval.synthetic import (
    clustered_embeddings,
    exact_topk,
    gaussian_embeddings,
    recall_at_k,
)

__all__ = [
    "RetrievalAgent",
    "SimpleTokenizer",
    "TextEmbedder",
    "FlatIndex",
    "DocumentParser",
    "CrossEncoder",
    "CrossEncoderReranker",
    "RecursiveCharacterTextSplitter",
    "clustered_embeddings",
    "exact_topk",
    "gaussian_embeddings",
    "recall_at_k",
]
