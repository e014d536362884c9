"""Packed corpus: the on-device path's replacement for the Indri index coupling.

``Corpus`` holds the whole training collection as flat numpy arrays —
concatenated in-vocabulary token ids plus per-document offsets — so instance
generation is vectorized gathers instead of the reference's per-document
TermList walks (data_indri.cpp:138-410, which loads every term list into RAM
anyway for the stochastic generator).

Document selection rules follow IndriSource::initialize
(data_indri.cpp:620-733):

* only documents whose tokenized length (post stopword removal, *before*
  vocabulary filtering) is >= window_size get a model document id, assigned
  in corpus order;
* an optional document list restricts and an optional cutoff truncates;
* OOV positions are dropped unless ``include_oov`` (emitted as id 0).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from cunvsm.config import DataConfig
from cunvsm.data.text import iter_corpus_files, load_stopwords, tokenize
from cunvsm.data.vocab import Vocabulary, build_vocabulary


@dataclasses.dataclass
class Corpus:
    vocab: Vocabulary
    # Concatenated in-vocabulary token ids of kept documents.
    tokens: np.ndarray  # int32 [total_invocab_tokens]
    doc_offsets: np.ndarray  # int64 [num_docs + 1]; doc d = tokens[o[d]:o[d+1]]
    # Tokenized length before vocabulary filtering (the "index length",
    # data_indri.cpp:680-686) — used for INV_DOC_FREQUENCY weighting.
    index_lengths: np.ndarray  # int64 [num_docs]
    docnos: List[str]  # model doc id -> external document identifier
    window_size: int
    # model doc id -> external index (Indri) document id; equals the model
    # id when the corpus wasn't built from an index (data_indri.cpp:557-571).
    index_doc_ids: Optional[np.ndarray] = None
    # Indexing-time stemmer name ("krovetz"/"porter") when built from a
    # stemmed Indri repository: the vocabulary then holds stemmed strings
    # and query tokenization must apply the same stemmer (data/stemming.py).
    stemmer: Optional[str] = None

    @property
    def num_docs(self) -> int:
        return len(self.docnos)

    @property
    def doc_lengths(self) -> np.ndarray:
        """In-vocabulary lengths."""
        return np.diff(self.doc_offsets)

    @property
    def avg_index_length(self) -> float:
        return float(self.index_lengths.mean())

    def docno_to_id(self) -> Dict[str, int]:
        return {d: i for i, d in enumerate(self.docnos)}

    # -- packed on-disk format (skip re-tokenization at collection scale) ---

    def save(self, path: str) -> None:
        """Persist the packed corpus (npz + sidecar term/docno strings)."""
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            tokens=self.tokens,
            doc_offsets=self.doc_offsets,
            index_lengths=self.index_lengths,
            term_freq=self.vocab.term_freq,
            index_term_ids=self.vocab.index_term_ids,
            total_terms=np.asarray(self.vocab.total_terms),
            index_doc_ids=(
                self.index_doc_ids
                if self.index_doc_ids is not None
                else np.arange(len(self.docnos), dtype=np.int64)
            ),
            include_oov=np.asarray(int(self.vocab.include_oov)),
            window_size=np.asarray(self.window_size),
            stemmer=np.asarray(self.stemmer or ""),
        )
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".vocab.txt", "w") as f:
            f.write("\n".join(self.vocab.terms) + "\n")
        with open(base + ".docnos.txt", "w") as f:
            f.write("\n".join(self.docnos) + "\n")

    @classmethod
    def load(cls, path: str) -> "Corpus":
        npz_path = path if path.endswith(".npz") else path + ".npz"
        base = npz_path[:-4]
        data = np.load(npz_path)
        with open(base + ".vocab.txt") as f:
            terms = f.read().split("\n")[:-1]
        with open(base + ".docnos.txt") as f:
            docnos = f.read().split("\n")[:-1]
        vocab = Vocabulary(
            terms=terms,
            term_to_id={t: i for i, t in enumerate(terms) if t},
            term_freq=data["term_freq"],
            total_terms=int(data["total_terms"]),
            include_oov=bool(int(data["include_oov"])),
            index_term_ids=data["index_term_ids"],
        )
        return cls(
            vocab=vocab,
            tokens=data["tokens"],
            doc_offsets=data["doc_offsets"],
            index_lengths=data["index_lengths"],
            docnos=docnos,
            window_size=int(data["window_size"]),
            index_doc_ids=(
                data["index_doc_ids"] if "index_doc_ids" in data else None
            ),
            stemmer=(
                (str(data["stemmer"]) or None) if "stemmer" in data else None
            ),
        )


def build_corpus(
    docs: Iterable[Tuple[str, str]],
    cfg: DataConfig,
    window_size: int,
    stopwords: Optional[frozenset] = None,
    document_list: Optional[Sequence[str]] = None,
    term_blacklist: Optional[frozenset] = None,
) -> Corpus:
    """Tokenize, select documents, build the vocabulary, and pack."""
    doc_filter = set(document_list) if document_list is not None else None

    docnos: List[str] = []
    tokenized: List[List[str]] = []
    for docno, text in docs:
        if doc_filter is not None and docno not in doc_filter:
            continue
        docnos.append(docno)
        tokenized.append(tokenize(text, stopwords))

    # Keep documents with index length >= window (data_indri.cpp:680-698),
    # then apply the cutoff.
    kept = [i for i, toks in enumerate(tokenized) if len(toks) >= window_size]
    if cfg.documents_cutoff > 0:
        kept = kept[: cfg.documents_cutoff]

    vocab = build_vocabulary(
        tokenized, cfg, kept_docs=kept, term_blacklist=term_blacklist
    )

    token_ids: List[np.ndarray] = []
    offsets = [0]
    index_lengths = []
    kept_docnos = []
    t2i = vocab.term_to_id
    for i in kept:
        toks = tokenized[i]
        if cfg.include_oov:
            ids = [t2i.get(t, 0) for t in toks]
        else:
            ids = [t2i[t] for t in toks if t in t2i]
        token_ids.append(np.asarray(ids, dtype=np.int32))
        offsets.append(offsets[-1] + len(ids))
        index_lengths.append(len(toks))
        kept_docnos.append(docnos[i])

    return Corpus(
        vocab=vocab,
        tokens=(
            np.concatenate(token_ids)
            if token_ids
            else np.zeros((0,), np.int32)
        ),
        doc_offsets=np.asarray(offsets, dtype=np.int64),
        index_lengths=np.asarray(index_lengths, dtype=np.int64),
        docnos=kept_docnos,
        window_size=window_size,
    )


def load_corpus(
    cfg: DataConfig,
    window_size: int,
    stopword_path: Optional[str] = None,
    use_native: bool = True,
) -> Corpus:
    """End-to-end corpus load from cfg.corpus_path.

    Uses the C++ ingestion library (native/corpus.cpp) when it is built and
    the input is a single TRECTEXT file without a document list; falls back
    to the pure-Python pipeline otherwise.  A ``.npz`` path loads a packed
    corpus previously written with ``Corpus.save`` (no re-tokenization).
    """
    if cfg.corpus_path.endswith(".npz"):
        packed = Corpus.load(cfg.corpus_path)
        if packed.window_size != window_size:
            raise ValueError(
                f"packed corpus was built with window "
                f"{packed.window_size}, requested {window_size}"
            )
        return packed

    from cunvsm.data.indri import (
        build_corpus_from_indri,
        is_indri_repository,
    )

    if is_indri_repository(cfg.corpus_path):
        if use_native:
            from cunvsm.data import native

            if native.available():
                return native.build_corpus_native_indri(
                    cfg.corpus_path, cfg, window_size
                )
        document_list = None
        if cfg.document_list:
            with open(cfg.document_list) as f:
                document_list = [line.strip() for line in f if line.strip()]
        blacklist = None
        if cfg.term_blacklist:
            with open(cfg.term_blacklist) as f:
                blacklist = frozenset(
                    line.strip().lower() for line in f if line.strip()
                )
        return build_corpus_from_indri(
            cfg.corpus_path, cfg, window_size,
            document_list=document_list, term_blacklist=blacklist,
        )
    if (
        use_native
        and os.path.isfile(cfg.corpus_path)
        and not cfg.corpus_path.endswith((".jsonl", ".json", ".gz"))
        and cfg.document_list is None
    ):
        from cunvsm.data import native

        if native.available():
            return native.build_corpus_native(
                cfg.corpus_path, cfg, window_size, stopword_path
            )
    stopwords = load_stopwords(stopword_path)
    document_list = None
    if cfg.document_list:
        with open(cfg.document_list) as f:
            document_list = [line.strip() for line in f if line.strip()]
    blacklist = None
    if cfg.term_blacklist:
        with open(cfg.term_blacklist) as f:
            blacklist = frozenset(
                line.strip().lower() for line in f if line.strip()
            )
    return build_corpus(
        iter_corpus_files(cfg.corpus_path),
        cfg,
        window_size,
        stopwords=stopwords,
        document_list=document_list,
        term_blacklist=blacklist,
    )
