"""ctypes bridge to the native corpus-ingestion library.

The C++ implementation (native/corpus.cpp) replicates the Python pipeline
(data/text.py + data/vocab.py + data/corpus.py) for TRECTEXT inputs at
collection-scale throughput; the Python path remains the semantic reference
and the fallback when the library isn't built.

Build with ``make -C native`` (g++ only; no external deps).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from cunvsm.config import DataConfig
from cunvsm.data.corpus import Corpus
from cunvsm.data.vocab import Vocabulary

_LIB_PATHS = [
    os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "libcunvsm_native.so"
    ),
    os.path.join(os.path.dirname(__file__), "libcunvsm_native.so"),
]

_lib = None
_lib_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    for path in _LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = _bind(ctypes.CDLL(os.path.abspath(path)))
            except (OSError, AttributeError) as e:
                # A stale/broken library (built before the full symbol
                # surface existed, or with a missing dependency): fall back
                # to the Python pipeline rather than breaking every corpus
                # load — but say so, and don't retry on every call.
                import logging

                logging.getLogger(__name__).warning(
                    "native library %s unusable (%s); falling back to the "
                    "Python ingestion pipeline — rebuild with "
                    "`make -C native`", path, e,
                )
                continue
            _lib = lib
            return lib
    _lib_failed = True
    return None


def reset_library() -> None:
    """Forget the cached probe result.

    ``load_library`` latches failure so a missing .so is not re-probed on
    every corpus load; a long-lived process that builds the library after
    the first probe (``make -C native``) can call this to pick it up
    without restarting."""
    global _lib, _lib_failed
    _lib = None
    _lib_failed = False


def _lowercased_blacklist(path: Optional[str]) -> Optional[str]:
    """Pre-lowercase a blacklist file with Python semantics.

    The Python pipeline lowercases blacklist entries with ``str.lower()``
    (data/corpus.py), which also folds non-ASCII letters; the native
    readers use ASCII ``std::tolower``.  Handing the native side an
    already-folded copy keeps the two pipelines byte-identical for any
    input.  Returns the path of a temporary file (or None/path unchanged
    when there is nothing to fold)."""
    if not path:
        return path
    import tempfile

    with open(path, encoding="utf-8", errors="replace") as f:
        raw = f.read()
    lowered = "\n".join(line.lower() for line in raw.splitlines())
    if lowered == raw.rstrip("\n"):
        return path
    tmp = tempfile.NamedTemporaryFile(
        "w", suffix=".blacklist", delete=False, encoding="utf-8"
    )
    tmp.write(lowered + "\n")
    tmp.close()
    return tmp.name


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.corpus_build.restype = ctypes.c_void_p
    lib.corpus_build.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
    ]
    lib.indri_build.restype = ctypes.c_void_p
    lib.indri_build.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
    ]
    lib.corpus_num_index_doc_ids.restype = ctypes.c_long
    lib.corpus_num_index_doc_ids.argtypes = [ctypes.c_void_p]
    lib.corpus_copy_index_doc_ids.restype = None
    lib.corpus_copy_index_doc_ids.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.corpus_error.restype = ctypes.c_char_p
    lib.corpus_error.argtypes = [ctypes.c_void_p]
    for name in (
        "corpus_num_docs", "corpus_num_tokens", "corpus_vocab_size",
        "corpus_total_terms", "corpus_vocab_bytes",
        "corpus_docnos_bytes",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    for name, ptr_t in (
        ("corpus_copy_tokens", ctypes.c_void_p),
        ("corpus_copy_offsets", ctypes.c_void_p),
        ("corpus_copy_index_lengths", ctypes.c_void_p),
        ("corpus_copy_term_freq", ctypes.c_void_p),
        ("corpus_copy_index_term_ids", ctypes.c_void_p),
        ("corpus_copy_vocab", ctypes.c_char_p),
        ("corpus_copy_docnos", ctypes.c_char_p),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ptr_t]
    lib.corpus_free.restype = None
    lib.corpus_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return load_library() is not None


def _corpus_from_handle(lib, handle, cfg, window_size) -> Corpus:
    try:
        err = lib.corpus_error(handle).decode()
        if err:
            raise RuntimeError(f"native corpus build failed: {err}")
        num_docs = lib.corpus_num_docs(handle)
        num_tokens = lib.corpus_num_tokens(handle)
        vocab_size = lib.corpus_vocab_size(handle)

        tokens = np.empty(num_tokens, dtype=np.int32)
        offsets = np.empty(num_docs + 1, dtype=np.int64)
        index_lengths = np.empty(num_docs, dtype=np.int64)
        term_freq = np.empty(vocab_size, dtype=np.int64)
        index_term_ids = np.empty(vocab_size, dtype=np.int64)
        if num_tokens:
            lib.corpus_copy_tokens(handle, tokens.ctypes.data)
        lib.corpus_copy_offsets(handle, offsets.ctypes.data)
        if num_docs:
            lib.corpus_copy_index_lengths(handle, index_lengths.ctypes.data)
        if vocab_size:
            lib.corpus_copy_term_freq(handle, term_freq.ctypes.data)
            lib.corpus_copy_index_term_ids(handle, index_term_ids.ctypes.data)
        index_doc_ids = None
        if lib.corpus_num_index_doc_ids(handle) == num_docs and num_docs:
            index_doc_ids = np.empty(num_docs, dtype=np.int64)
            lib.corpus_copy_index_doc_ids(handle, index_doc_ids.ctypes.data)

        vb = ctypes.create_string_buffer(lib.corpus_vocab_bytes(handle))
        lib.corpus_copy_vocab(handle, vb)
        terms = vb.raw.decode().split("\n")[:-1]
        db = ctypes.create_string_buffer(lib.corpus_docnos_bytes(handle))
        lib.corpus_copy_docnos(handle, db)
        docnos = db.raw.decode().split("\n")[:-1]

        vocab = Vocabulary(
            terms=terms,
            term_to_id={t: i for i, t in enumerate(terms) if t},
            term_freq=term_freq,
            total_terms=int(lib.corpus_total_terms(handle)),
            include_oov=cfg.include_oov,
            index_term_ids=index_term_ids,
        )
        return Corpus(
            vocab=vocab,
            tokens=tokens,
            doc_offsets=offsets,
            index_lengths=index_lengths,
            docnos=docnos,
            window_size=window_size,
            index_doc_ids=index_doc_ids,
        )
    finally:
        lib.corpus_free(handle)


def build_corpus_native_indri(
    repository_path: str,
    cfg: DataConfig,
    window_size: int,
) -> Corpus:
    """Packed corpus from an Indri DiskIndex repository (native/indri.cpp)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    blacklist = _lowercased_blacklist(cfg.term_blacklist)
    try:
        handle = lib.indri_build(
            repository_path.encode(),
            (cfg.document_list or "").encode(),
            (blacklist or "").encode(),
            window_size,
            cfg.max_vocabulary_size,
            cfg.min_document_frequency,
            float(cfg.max_document_frequency),
            int(cfg.include_oov),
            int(cfg.include_digits),
            cfg.documents_cutoff,
        )
        return _corpus_from_handle(lib, handle, cfg, window_size)
    finally:
        if blacklist and blacklist != cfg.term_blacklist:
            os.unlink(blacklist)


def build_corpus_native(
    trectext_path: str,
    cfg: DataConfig,
    window_size: int,
    stopword_path: Optional[str] = None,
) -> Corpus:
    lib = load_library()
    if lib is None:
        raise RuntimeError(
            "native library not built; run `make -C native`"
        )
    blacklist = _lowercased_blacklist(cfg.term_blacklist)
    try:
        handle = lib.corpus_build(
            trectext_path.encode(),
            (stopword_path or "").encode(),
            (blacklist or "").encode(),
            window_size,
            cfg.max_vocabulary_size,
            cfg.min_document_frequency,
            float(cfg.max_document_frequency),
            int(cfg.include_oov),
            int(cfg.include_digits),
            cfg.documents_cutoff,
        )
        return _corpus_from_handle(lib, handle, cfg, window_size)
    finally:
        if blacklist and blacklist != cfg.term_blacklist:
            os.unlink(blacklist)
