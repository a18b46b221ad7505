"""Cross-encoder reranker.

Port of `intel_extension_for_transformers_tpu/retrieval/reranker.py`:
[CLS] query [SEP] doc [SEP] → BERT → tanh(pooler) → classifier → score, one
batch for up to `batch_size` pairs. With a few hits of a few hundred tokens
each, M = pairs·tokens stays under 1024, so an INT4 cross-encoder's linear
layers run K1.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig, BertModel
from intel_extension_for_transformers_tpu_torch.retrieval.embedder import SimpleTokenizer


class CrossEncoder(BertModel):
    """BERT encoder + pooler + a (H → 1) classifier head. The classifier
    sits at the top of the module tree, as in the JAX params tree."""

    def __init__(self, config: BertConfig):
        super().__init__(config)
        self.classifier = nn.Linear(config.hidden_size, 1)


class CrossEncoderReranker:
    def __init__(
        self,
        model: CrossEncoder,
        config: BertConfig,
        tokenizer=None,
        *,
        batch_size: int = 64,
        max_length: int = 512,
    ):
        self.model = model
        self.config = config
        self.tokenizer = tokenizer or SimpleTokenizer(config.vocab_size)
        self.batch_size = batch_size
        self.max_length = max_length

    @torch.inference_mode()
    def _score_batch(self, input_ids, attention_mask, token_type_ids) -> np.ndarray:
        dev = self.model.embeddings.word_embeddings.device
        hidden = self.model(
            torch.as_tensor(input_ids, device=dev),
            torch.as_tensor(attention_mask, device=dev),
            torch.as_tensor(token_type_ids, device=dev),
        )
        cls = torch.tanh(self.model.pooler(hidden[:, 0, :]))
        logits = self.model.classifier(cls)
        return logits[:, 0].to(torch.float32).cpu().numpy()

    def _tokenize_pair(self, query: str, doc: str):
        if hasattr(self.tokenizer, "encode_one"):  # SimpleTokenizer
            q = self.tokenizer.encode_one(query, self.max_length // 2)
            d = self.tokenizer.encode_one(doc, self.max_length // 2)[1:]  # drop CLS
            return q + d, [0] * len(q) + [1] * len(d)
        enc = self.tokenizer(query, doc, truncation=True, max_length=self.max_length)
        return enc["input_ids"], enc.get("token_type_ids", [0] * len(enc["input_ids"]))

    def score(self, query: str, docs: List[str]) -> np.ndarray:
        """Relevance score per (query, doc) pair."""
        pairs = [self._tokenize_pair(query, d) for d in docs]
        L = min(max(len(p[0]) for p in pairs), self.max_length)
        scores = np.zeros((len(docs),), np.float32)
        for i0 in range(0, len(pairs), self.batch_size):
            chunk = pairs[i0 : i0 + self.batch_size]
            B = len(chunk)
            ids = np.zeros((B, L), np.int32)
            mask = np.zeros((B, L), np.int32)
            types = np.zeros((B, L), np.int32)
            for j, (pid, pty) in enumerate(chunk):
                n = min(len(pid), L)
                ids[j, :n] = pid[:n]
                mask[j, :n] = 1
                types[j, :n] = pty[:n]
            scores[i0 : i0 + B] = self._score_batch(ids, mask, types)
        return scores

    def rerank(self, query: str, docs: List[dict], top_n: int = 3) -> List[dict]:
        """Score, sort descending, keep top_n, attach `relevance_score`."""
        if not docs:
            return []
        scores = self.score(query, [d["content"] for d in docs])
        order = np.argsort(-scores)[:top_n]
        out = []
        for i in order:
            d = dict(docs[int(i)])
            md = dict(d.get("metadata", {}))
            md["relevance_score"] = float(scores[int(i)])
            d["metadata"] = md
            out.append(d)
        return out
