"""Document loading + parsing for RAG knowledge bases.

Port of `intel_extension_for_transformers_tpu/retrieval/parser.py`, host
code that is the same in both packages. txt, md, json and jsonl parse with
the standard library; html (beautifulsoup4), csv and xlsx (pandas), pdf
(pymupdf or pypdf) and docx (python-docx) import their package on use, and a
file whose package is missing is skipped with a warning.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import List, Optional

logger = logging.getLogger(__name__)

Document = dict  # {"content": str, "metadata": dict}


def _doc(content: str, **metadata) -> Document:
    return {"content": content, "metadata": metadata}


def load_txt(path: str) -> List[Document]:
    with open(path, encoding="utf-8", errors="replace") as f:
        return [_doc(f.read(), source=path)]


def load_markdown(path: str) -> List[Document]:
    return load_txt(path)


def load_html(path: str) -> List[Document]:
    try:
        from bs4 import BeautifulSoup
    except ImportError:
        raise ImportError("html parsing requires beautifulsoup4")
    with open(path, encoding="utf-8", errors="replace") as f:
        soup = BeautifulSoup(f.read(), "html.parser")
    for tag in soup(["script", "style"]):
        tag.decompose()
    text = re.sub(r"\n{3,}", "\n\n", soup.get_text("\n"))
    return [_doc(text.strip(), source=path)]


def load_json(path: str) -> List[Document]:
    """json/jsonl: mirrors the reference's {content, link} schema
    (context_utils.py laod_json) but accepts arbitrary dicts/strings."""
    docs: List[Document] = []
    with open(path, encoding="utf-8") as f:
        if path.endswith(".jsonl"):
            records = [json.loads(line) for line in f if line.strip()]
        else:
            data = json.load(f)
            records = data if isinstance(data, list) else [data]
    for r in records:
        if isinstance(r, str):
            docs.append(_doc(r, source=path))
        elif isinstance(r, dict):
            content = r.get("content") or r.get("text") or json.dumps(r)
            md = {k: v for k, v in r.items() if k not in ("content", "text")}
            md["source"] = path
            docs.append({"content": str(content), "metadata": md})
    return docs


def load_csv(path: str) -> List[Document]:
    import pandas as pd

    df = pd.read_csv(path)
    return _from_dataframe(df, path)


def load_xlsx(path: str) -> List[Document]:
    import pandas as pd

    df = pd.read_excel(path)
    return _from_dataframe(df, path)


def _from_dataframe(df, path: str) -> List[Document]:
    """Q&A-style sheets (question/answer columns, like the reference's
    load_xlsx/load_csv) become one doc per row; otherwise rows stringify."""
    cols = {c.lower().strip(): c for c in df.columns}
    docs = []
    if "question" in cols and ("answer" in cols or "answers" in cols):
        acol = cols.get("answer", cols.get("answers"))
        for _, row in df.iterrows():
            q, a = str(row[cols["question"]]), str(row[acol])
            docs.append(_doc(f"Question: {q}  Answer: {a}", source=path))
    else:
        for i, row in df.iterrows():
            docs.append(
                _doc("  ".join(f"{c}: {row[c]}" for c in df.columns), source=path, row=int(i))
            )
    return docs


def load_pdf(path: str) -> List[Document]:
    try:
        import fitz  # pymupdf
    except ImportError:
        try:
            from pypdf import PdfReader
        except ImportError:
            raise ImportError(
                "pdf parsing requires pymupdf or pypdf (not installed in this "
                "environment; convert to txt/md first)"
            )
        reader = PdfReader(path)
        return [
            _doc(page.extract_text() or "", source=path, page=i)
            for i, page in enumerate(reader.pages)
        ]
    docs = []
    with fitz.open(path) as pdf:
        for i, page in enumerate(pdf):
            docs.append(_doc(page.get_text(), source=path, page=i))
    return docs


def load_docx(path: str) -> List[Document]:
    try:
        import docx
    except ImportError:
        raise ImportError("docx parsing requires python-docx (not installed)")
    d = docx.Document(path)
    return [_doc("\n".join(p.text for p in d.paragraphs), source=path)]


LOADERS = {
    ".txt": load_txt,
    ".md": load_markdown,
    ".markdown": load_markdown,
    ".html": load_html,
    ".htm": load_html,
    ".json": load_json,
    ".jsonl": load_json,
    ".csv": load_csv,
    ".xlsx": load_xlsx,
    ".pdf": load_pdf,
    ".docx": load_docx,
}


class DocumentParser:
    """Load files/dirs into chunked documents
    (reference: parser.py:40 DocumentParser.load → chunk)."""

    def __init__(self, chunk_size: int = 512, chunk_overlap: int = 32):
        from intel_extension_for_transformers_tpu_torch.retrieval.splitter import (
            RecursiveCharacterTextSplitter,
        )

        self.splitter = RecursiveCharacterTextSplitter(
            chunk_size=chunk_size, chunk_overlap=chunk_overlap
        )

    def supported(self, path: str) -> bool:
        return os.path.splitext(path)[1].lower() in LOADERS

    def load_file(self, path: str) -> List[Document]:
        ext = os.path.splitext(path)[1].lower()
        loader = LOADERS.get(ext)
        if loader is None:
            raise ValueError(
                f"unsupported document format {ext!r}; supported: {sorted(LOADERS)}"
            )
        return loader(path)

    def load(
        self, input_path: str, *, chunk: bool = True, max_files: Optional[int] = None
    ) -> List[Document]:
        """Parse a file or directory tree → (optionally chunked) documents."""
        paths: List[str] = []
        if os.path.isdir(input_path):
            for root, _, files in os.walk(input_path):
                for fn in sorted(files):
                    p = os.path.join(root, fn)
                    if self.supported(p):
                        paths.append(p)
        elif os.path.isfile(input_path):
            paths = [input_path]
        else:
            raise FileNotFoundError(input_path)
        if max_files:
            paths = paths[:max_files]

        docs: List[Document] = []
        for p in paths:
            try:
                docs.extend(self.load_file(p))
            except ImportError as e:
                logger.warning("skipping %s: %s", p, e)
        if chunk:
            docs = self.splitter.split_documents(docs)
        return docs
