"""Differential tests: native (C++) corpus ingestion vs the Python pipeline.

The Python implementation is the semantic oracle; the native path must
produce identical packed corpora for the same inputs.  Skipped when the
library hasn't been built (``make -C native``).
"""

import os
import subprocess

import numpy as np
import pytest

from cunvsm.config import DataConfig
from cunvsm.data import native
from cunvsm.data.corpus import build_corpus
from cunvsm.data.text import iter_trectext

REPO_ROOT = os.path.join(os.path.dirname(__file__), "..")


def ensure_built():
    if native.available():
        return True
    try:
        subprocess.run(
            ["make", "-C", os.path.join(REPO_ROOT, "native")],
            check=True,
            capture_output=True,
        )
    except Exception:
        return False
    return native.available()


pytestmark = pytest.mark.skipif(
    not ensure_built(), reason="native library unavailable"
)


@pytest.fixture
def trectext(tmp_path):
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(40)] + ["42", "3.5", "the"]
    path = tmp_path / "docs.trectext"
    with open(path, "w") as f:
        for d in range(25):
            n = rng.randint(2, 40)
            body = " ".join(words[rng.randint(len(words))] for _ in range(n))
            f.write(
                f"<DOC>\n<DOCNO> doc{d} </DOCNO>\n<TITLE>Title {d}</TITLE>\n"
                f"<TEXT>\n{body}\n</TEXT>\n</DOC>\n"
            )
    return str(path)


CONFIGS = [
    DataConfig(max_vocabulary_size=0, min_document_frequency=0,
               max_document_frequency=0),
    DataConfig(max_vocabulary_size=10, min_document_frequency=0,
               max_document_frequency=0),
    DataConfig(max_vocabulary_size=0, min_document_frequency=3,
               max_document_frequency=0.5),
    DataConfig(max_vocabulary_size=0, min_document_frequency=0,
               max_document_frequency=0, include_oov=True),
    DataConfig(max_vocabulary_size=0, min_document_frequency=0,
               max_document_frequency=0, include_digits=True),
    DataConfig(max_vocabulary_size=0, min_document_frequency=0,
               max_document_frequency=0, documents_cutoff=7),
]


@pytest.mark.parametrize("cfg_idx", range(len(CONFIGS)))
def test_native_matches_python(trectext, cfg_idx):
    cfg = CONFIGS[cfg_idx]
    window = 4
    py = build_corpus(iter_trectext(trectext), cfg, window)
    nat = native.build_corpus_native(trectext, cfg, window)

    assert nat.docnos == py.docnos
    assert nat.vocab.terms == py.vocab.terms
    np.testing.assert_array_equal(nat.vocab.term_freq, py.vocab.term_freq)
    assert nat.vocab.total_terms == py.vocab.total_terms
    np.testing.assert_array_equal(nat.tokens, py.tokens)
    np.testing.assert_array_equal(nat.doc_offsets, py.doc_offsets)
    np.testing.assert_array_equal(nat.index_lengths, py.index_lengths)


def test_native_with_stopwords(trectext, tmp_path):
    stop = tmp_path / "stop.txt"
    stop.write_text("the\nw0\n")
    cfg = CONFIGS[0]
    from cunvsm.data.text import load_stopwords

    py = build_corpus(
        iter_trectext(trectext), cfg, 4,
        stopwords=load_stopwords(str(stop)),
    )
    nat = native.build_corpus_native(
        trectext, cfg, 4, stopword_path=str(stop)
    )
    assert nat.vocab.terms == py.vocab.terms
    np.testing.assert_array_equal(nat.tokens, py.tokens)


def test_native_cranfield_if_available():
    path = "/root/reference/test_data/cranfield_collection/cranfield.trectext"
    if not os.path.exists(path):
        pytest.skip("reference test data unavailable")
    cfg = DataConfig(
        max_vocabulary_size=65536,
        min_document_frequency=0,
        max_document_frequency=0.5,
    )
    py = build_corpus(iter_trectext(path), cfg, 10)
    nat = native.build_corpus_native(path, cfg, 10)
    assert nat.docnos == py.docnos
    assert nat.vocab.terms == py.vocab.terms
    np.testing.assert_array_equal(nat.tokens, py.tokens)


BROWN = "/root/reference/test_data/Brown_index"


@pytest.mark.skipif(
    not native.available() or not os.path.isdir(BROWN),
    reason="native library or Brown index unavailable",
)
class TestNativeIndri:
    """native/indri.cpp vs the Python Indri reader (the semantic oracle)."""

    @pytest.mark.parametrize(
        "kwargs",
        [
            dict(max_vocabulary_size=0, min_document_frequency=0,
                 max_document_frequency=0),
            dict(max_vocabulary_size=2000, min_document_frequency=2,
                 max_document_frequency=0.5),
            dict(max_vocabulary_size=500, min_document_frequency=0,
                 max_document_frequency=100, include_oov=True),
            dict(max_vocabulary_size=0, min_document_frequency=0,
                 max_document_frequency=0, documents_cutoff=37),
        ],
    )
    def test_differential(self, kwargs):
        from cunvsm.data.indri import build_corpus_from_indri

        cfg = DataConfig(corpus_path=BROWN, **kwargs)
        want = build_corpus_from_indri(BROWN, cfg, 16)
        got = native.build_corpus_native_indri(BROWN, cfg, 16)

        assert got.docnos == want.docnos
        assert got.vocab.terms == want.vocab.terms
        np.testing.assert_array_equal(got.vocab.term_freq,
                                      want.vocab.term_freq)
        np.testing.assert_array_equal(got.vocab.index_term_ids,
                                      want.vocab.index_term_ids)
        assert got.vocab.total_terms == want.vocab.total_terms
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.doc_offsets, want.doc_offsets)
        np.testing.assert_array_equal(got.index_lengths, want.index_lengths)
        np.testing.assert_array_equal(got.index_doc_ids, want.index_doc_ids)

    def test_document_list(self, tmp_path):
        from cunvsm.data.indri import build_corpus_from_indri

        doclist = tmp_path / "docs.txt"
        doclist.write_text("cj36\nck17\ncn04\ncg62\ncm02\n")
        cfg = DataConfig(
            corpus_path=BROWN, max_vocabulary_size=0,
            min_document_frequency=0, max_document_frequency=0,
            document_list=str(doclist),
        )
        want = build_corpus_from_indri(
            BROWN, cfg, 3,
            document_list=["cj36", "ck17", "cn04", "cg62", "cm02"],
        )
        got = native.build_corpus_native_indri(BROWN, cfg, 3)
        assert got.docnos == want.docnos
        np.testing.assert_array_equal(got.index_doc_ids, want.index_doc_ids)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.vocab.term_freq,
                                      want.vocab.term_freq)

    def test_term_blacklist_case_insensitive(self, tmp_path):
        """Blacklist entries are lowercased on both paths (the Python
        pipeline's contract); a mixed-case entry must still drop the term."""
        from cunvsm.data.indri import build_corpus_from_indri

        blacklist = tmp_path / "blacklist.txt"
        blacklist.write_text("TIME\nState\n")
        cfg = DataConfig(
            corpus_path=BROWN, max_vocabulary_size=0,
            min_document_frequency=0, max_document_frequency=0,
            term_blacklist=str(blacklist),
        )
        want = build_corpus_from_indri(
            BROWN, cfg, 16, term_blacklist=frozenset({"time", "state"})
        )
        got = native.build_corpus_native_indri(BROWN, cfg, 16)
        assert "time" not in got.vocab.term_to_id
        assert "state" not in got.vocab.term_to_id
        assert got.vocab.terms == want.vocab.terms
        np.testing.assert_array_equal(got.tokens, want.tokens)


def test_native_matches_python_on_randomized_corpora(tmp_path):
    # Differential fuzz: random trectext corpora x random filter configs;
    # the Python pipeline is the semantic oracle for native/corpus.cpp.
    import dataclasses
    import random

    from cunvsm.data import native

    if not native.available():
        pytest.skip("native library not built (make -C native)")

    rng = random.Random(17)
    for trial in range(4):
        num_docs = rng.randint(3, 60)
        vocab = [f"w{i}" for i in range(rng.randint(5, 120))]
        path = str(tmp_path / f"c{trial}.trectext")
        with open(path, "w") as f:
            for d in range(num_docs):
                body = " ".join(
                    rng.choice(vocab + ["42", "3.5"])
                    for _ in range(rng.randint(1, 80))
                )
                f.write(
                    f"<DOC>\n<DOCNO>d{d}</DOCNO>\n<TEXT>\n{body}\n"
                    "</TEXT>\n</DOC>\n"
                )
        cfg = DataConfig(
            corpus_path=path,
            max_vocabulary_size=rng.choice([0, 8, 64]),
            min_document_frequency=rng.choice([0, 2]),
            max_document_frequency=rng.choice([0, 0.5]),
        )
        window = rng.randint(2, 8)
        cp = build_corpus(list(iter_trectext(path)), cfg, window)
        cn = native.build_corpus_native(path, cfg, window)
        assert cn.vocab.terms == cp.vocab.terms, (trial, cfg)
        np.testing.assert_array_equal(cn.vocab.term_freq, cp.vocab.term_freq)
        np.testing.assert_array_equal(cn.tokens, cp.tokens)
        np.testing.assert_array_equal(cn.doc_offsets, cp.doc_offsets)
        assert cn.docnos == cp.docnos
