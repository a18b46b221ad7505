"""Text chunking for RAG indexing.

Port of `intel_extension_for_transformers_tpu/retrieval/splitter.py`, the
pure-Python path: recursive split on a separator hierarchy, greedy merge up
to chunk_size with overlap carry-over. It yields the same chunks as the JAX
package's splitter, whose native C++ engine implements this same algorithm
for the default configuration; that engine is not ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional

DEFAULT_SEPARATORS = ["\n\n", "\n", ". ", " ", ""]


class RecursiveCharacterTextSplitter:
    def __init__(
        self,
        chunk_size: int = 512,
        chunk_overlap: int = 32,
        separators: Optional[List[str]] = None,
        length_function: Callable[[str], int] = len,
        keep_separator: bool = True,
    ):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or DEFAULT_SEPARATORS
        self.length = length_function
        self.keep_separator = keep_separator

    def split_text(self, text: str) -> List[str]:
        chunks = self._split(text, self.separators)
        return [c for c in (c.strip() for c in chunks) if c]

    def _split(self, text: str, separators: List[str]) -> List[str]:
        if self.length(text) <= self.chunk_size:
            return [text]
        # first separator actually present (last-resort "" always matches)
        idx = next(
            (i for i, s in enumerate(separators) if s == "" or s in text),
            len(separators) - 1,
        )
        sep, rest = separators[idx], separators[idx + 1 :]
        if sep == "":
            # character-level fallback with overlap stride
            stride = max(self.chunk_size - self.chunk_overlap, 1)
            return [text[i : i + self.chunk_size] for i in range(0, len(text), stride)]
        parts = text.split(sep)
        if self.keep_separator:
            parts = [p + sep for p in parts[:-1]] + parts[-1:]
        # merge runs of small siblings; oversize parts recurse and their
        # sub-chunks pass through final (no re-merge, so no size creep)
        out: List[str] = []
        small: List[str] = []
        for p in parts:
            if self.length(p) <= self.chunk_size:
                small.append(p)
            else:
                if small:
                    out.extend(self._merge(small))
                    small = []
                out.extend(self._split(p, rest) if rest else [p])
        if small:
            out.extend(self._merge(small))
        return out

    def _merge(self, atoms: List[str]) -> List[str]:
        chunks: List[str] = []
        cur = ""
        for a in atoms:
            if cur and self.length(cur) + self.length(a) > self.chunk_size:
                chunks.append(cur)
                # overlap: carry the tail of the finished chunk
                cur = cur[-self.chunk_overlap :] + a if self.chunk_overlap > 0 else a
            else:
                cur += a
        if cur:
            chunks.append(cur)
        return chunks

    def split_documents(self, docs: List[dict]) -> List[dict]:
        """docs: [{"content": str, "metadata": {...}}] → chunked docs."""
        out = []
        for d in docs:
            for i, chunk in enumerate(self.split_text(d["content"])):
                md = dict(d.get("metadata", {}))
                md["chunk"] = i
                out.append({"content": chunk, "metadata": md})
        return out
