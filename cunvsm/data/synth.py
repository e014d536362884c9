"""Synthetic-corpus assembly for benchmarks and protocol rehearsals.

Real TREC/Reuters/Amazon corpora are licensed data absent from this
environment, so collection-scale measurements (scripts/e2e_throughput.py,
scripts/profile_step.py --device_sampling, scripts/collection_scale_study.py)
run on synthetic token streams.  This module is the single place that
turns a packed token matrix into a `Corpus` (terms t0..tN, docnos d0..dN,
fixed document length), so the scripts cannot drift apart on the
Vocabulary/Corpus field contract.
"""

from __future__ import annotations

import numpy as np

from cunvsm.data.corpus import Corpus
from cunvsm.data.vocab import Vocabulary


def corpus_from_tokens(
    tokens: np.ndarray,
    num_docs: int,
    doc_len: int,
    vocab_size: int,
    window_size: int = 10,
) -> Corpus:
    """Fixed-length-document corpus over a synthetic t0..tN vocabulary."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
    assert len(tokens) == num_docs * doc_len
    counts = np.bincount(tokens, minlength=vocab_size).astype(np.int64)
    vocab = Vocabulary(
        terms=[f"t{i}" for i in range(vocab_size)],
        term_to_id={f"t{i}": i for i in range(vocab_size)},
        term_freq=counts,
        total_terms=int(counts.sum()),
        include_oov=False,
        index_term_ids=np.arange(vocab_size, dtype=np.int64),
    )
    return Corpus(
        vocab=vocab,
        tokens=tokens,
        doc_offsets=np.arange(num_docs + 1, dtype=np.int64) * doc_len,
        index_lengths=np.full(num_docs, doc_len, dtype=np.int64),
        docnos=[f"d{i}" for i in range(num_docs)],
        window_size=window_size,
    )


def zipf_corpus(
    num_docs: int,
    doc_len: int,
    vocab_size: int = 65536,
    exponent: float = 1.07,
    window_size: int = 10,
    seed: int = 4242,
) -> Corpus:
    """Zipf-distributed tokens (duplicate-heavy scatter streams like real
    text) via inverse-CDF sampling over the rank distribution."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** exponent
    cdf = np.cumsum(p / p.sum())
    tokens = np.searchsorted(
        cdf, rng.random_sample(num_docs * doc_len)
    ).astype(np.int32)
    return corpus_from_tokens(
        tokens, num_docs, doc_len, vocab_size, window_size
    )


def uniform_corpus(
    num_docs: int,
    doc_len: int,
    vocab_size: int,
    window_size: int = 10,
    seed: int = 0,
) -> Corpus:
    """Uniform-random tokens (the profiling default)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab_size, num_docs * doc_len).astype(np.int32)
    return corpus_from_tokens(
        tokens, num_docs, doc_len, vocab_size, window_size
    )
