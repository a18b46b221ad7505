"""RetrievalAgent — the RAG pipeline plugin, dense retrieval.

Port of `intel_extension_for_transformers_tpu/retrieval/agent.py` for
`retrieval_type="default"`: document parsing → chunking → embedding → flat
index build; at query time retrieve → optional rerank → QA prompt, exposed
through the plugin hook `pre_llm_inference_actions`. The index lives on the
embedder's device. The bm25 and child_parent retrieval types are not ported
yet.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from intel_extension_for_transformers_tpu_torch.retrieval.index import FlatIndex
from intel_extension_for_transformers_tpu_torch.retrieval.parser import DocumentParser

QA_PROMPT_TEMPLATE = """Have a conversation with a human. You are required to generate a suitable response to the query from the human.
### Context: {context}
### Question: {question}
### Response:"""

NO_CONTEXT_TEMPLATE = """Have a conversation with a human, answer the following question as best you can.
### Question: {question}
### Response:"""


class RetrievalAgent:
    def __init__(
        self,
        embedder,
        input_path: Optional[str] = None,
        *,
        index_dtype: str = "bfloat16",
        persist_directory: Optional[str] = None,
        top_k: int = 4,
        threshold: float = 0.0,
        reranker=None,
        rerank_top_n: int = 3,
        chunk_size: int = 512,
        chunk_overlap: int = 32,
        documents: Optional[List[dict]] = None,
    ):
        self.embedder = embedder
        self.top_k = top_k
        self.threshold = threshold
        self.reranker = reranker
        self.rerank_top_n = rerank_top_n
        self.persist_directory = persist_directory
        self.parser = DocumentParser(chunk_size=chunk_size, chunk_overlap=chunk_overlap)
        self.docs: List[dict] = []
        self.index: Optional[FlatIndex] = None
        self._index_dtype = index_dtype

        if persist_directory and os.path.exists(os.path.join(persist_directory, "index.json")):
            self.reload_localdb(persist_directory)
        if input_path:
            self.append_localdb(input_path)
        if documents:
            self.add_documents(documents)

    # -- knowledge-base management --

    def append_localdb(self, input_path: str) -> None:
        docs = self.parser.load(input_path)
        if not docs:
            raise ValueError(f"no parseable documents under {input_path}")
        self.add_documents(docs)

    def create(self, input_path: str) -> None:
        """Rebuild the knowledge base from scratch."""
        self.docs = []
        self.index = None
        self.append_localdb(input_path)

    def add_documents(self, docs: List[dict]) -> None:
        self.docs.extend(docs)
        vecs = self.embedder.encode([d["content"] for d in docs])
        if self.index is None:
            self.index = FlatIndex(
                dim=vecs.shape[1], dtype=self._index_dtype, device=self.embedder.device
            )
        self.index.add(vecs)
        if self.persist_directory:
            self.save(self.persist_directory)

    def save(self, path: str) -> None:
        if self.index is not None:
            self.index.save(path)
            with open(os.path.join(path, "docs.json"), "w") as f:
                json.dump(self.docs, f)

    def reload_localdb(self, path: str) -> None:
        self.index = FlatIndex.load(path, device=self.embedder.device)
        with open(os.path.join(path, "docs.json")) as f:
            self.docs = json.load(f)

    # -- query path --

    def get_context(self, query: str, k: Optional[int] = None) -> List[dict]:
        k = k or self.top_k
        if self.index is None or len(self.index) == 0:
            return []
        qv = self.embedder.encode([query], is_query=True)
        scores, ids = self.index.search(qv, k=min(k, len(self.index)))
        hits = []
        for s, i in zip(scores[0], ids[0]):
            if s >= self.threshold:
                d = dict(self.docs[int(i)])
                md = dict(d.get("metadata", {}))
                md["score"] = float(s)
                d["metadata"] = md
                hits.append(d)
        if self.reranker is not None and hits:
            hits = self.reranker.rerank(query, hits, top_n=self.rerank_top_n)
        return hits

    def pre_llm_inference_actions(self, query: str) -> str:
        """Plugin hook: query → retrieval-augmented prompt."""
        hits = self.get_context(query)
        if not hits:
            return NO_CONTEXT_TEMPLATE.format(question=query)
        context = "\n".join(d["content"] for d in hits)
        return QA_PROMPT_TEMPLATE.format(context=context, question=query)
