"""QLM lexical ranker unit tests against manual probability computations."""

import numpy as np
import pytest

from cunvsm.config import DataConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.query.qlm import build_qlm_index, qlm_rank, tfidf_rank


@pytest.fixture
def index():
    docs = [
        ("d0", "apple apple banana"),
        ("d1", "banana cherry cherry"),
        ("d2", "apple cherry date"),
    ]
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=1,
    )
    return corpus, build_qlm_index(corpus)


def test_index_stats(index):
    corpus, idx = index
    assert idx.doc_term.shape == (3, corpus.vocab.size)
    np.testing.assert_array_equal(idx.doc_lengths, [3, 3, 3])
    apple = idx.term_to_id["apple"]
    np.testing.assert_allclose(idx.collection_prob[apple], 3 / 9)


def test_jm_scores_match_manual(index):
    corpus, idx = index
    run = qlm_rank(idx, {"q": ["apple"]}, smoothing="jm", param=0.5,
                   top_k=3)
    scores = dict(run["q"])
    # p(apple|d) = 0.5*tf/3 + 0.5*(3/9)
    want = {
        "d0": np.log(0.5 * 2 / 3 + 0.5 * 3 / 9),
        "d1": np.log(0.5 * 0 / 3 + 0.5 * 3 / 9),
        "d2": np.log(0.5 * 1 / 3 + 0.5 * 3 / 9),
    }
    for d, s in want.items():
        np.testing.assert_allclose(scores[d], s, rtol=1e-10)
    assert run["q"][0][0] == "d0"


def test_dirichlet_scores_match_manual(index):
    corpus, idx = index
    mu = 10.0
    run = qlm_rank(idx, {"q": ["cherry"]}, smoothing="dirichlet", param=mu)
    scores = dict(run["q"])
    pc = 3 / 9
    want_d1 = np.log((2 + mu * pc) / (3 + mu))
    np.testing.assert_allclose(scores["d1"], want_d1, rtol=1e-10)
    assert run["q"][0][0] == "d1"


def test_multi_term_query_sums_logs(index):
    corpus, idx = index
    run = qlm_rank(idx, {"q": ["apple", "banana"]}, smoothing="jm", param=0.5)
    one = qlm_rank(idx, {"q": ["apple"]}, smoothing="jm", param=0.5)
    two = qlm_rank(idx, {"q": ["banana"]}, smoothing="jm", param=0.5)
    s = dict(run["q"])
    np.testing.assert_allclose(
        s["d0"], dict(one["q"])["d0"] + dict(two["q"])["d0"], rtol=1e-10
    )


def test_oov_query_skipped(index):
    corpus, idx = index
    run = qlm_rank(idx, {"q": ["zzzz"]})
    assert "q" not in run


def test_prf_improves_or_changes_ranking(index):
    corpus, idx = index
    run = qlm_rank(idx, {"q": ["apple"]}, smoothing="jm", prf=True,
                   fb_docs=2, fb_terms=3)
    assert "q" in run and len(run["q"]) == 3
    assert all(np.isfinite(s) for _, s in run["q"])


def test_tfidf_only_exact_matches(index):
    corpus, idx = index
    ranked = tfidf_rank(idx, ["date"])
    assert [d for d, _ in ranked] == ["d2"]


def test_indri_prf_posterior_is_geometric_mean(index):
    """The 'indri' posterior (RMExpander reconstruction) divides the
    feedback-doc log-likelihood by the query mass before exponentiating —
    with a MULTI-term query the flatter posterior yields different
    relevance-model weights than rm1, and for a single-term query the two
    posteriors coincide up to the shared normalization (identical runs)."""
    corpus, idx = index
    # Single-term query: log-likelihoods scale by 1/1 — identical runs.
    r1 = qlm_rank(idx, {"q": ["apple"]}, smoothing="jm", prf=True,
                  fb_docs=2, fb_terms=3, prf_posterior="rm1")
    r2 = qlm_rank(idx, {"q": ["apple"]}, smoothing="jm", prf=True,
                  fb_docs=2, fb_terms=3, prf_posterior="indri")
    assert [d for d, _ in r1["q"]] == [d for d, _ in r2["q"]]
    np.testing.assert_allclose(
        [s for _, s in r1["q"]], [s for _, s in r2["q"]], rtol=1e-12
    )
    # Multi-term: valid, finite, full ranking.
    r3 = qlm_rank(idx, {"q": ["apple", "cherry", "cherry"]}, smoothing="jm",
                  prf=True, fb_docs=2, fb_terms=3, prf_posterior="indri")
    assert len(r3["q"]) == 3
    assert all(np.isfinite(s) for _, s in r3["q"])
    with pytest.raises(ValueError, match="prf_posterior"):
        qlm_rank(idx, {"q": ["apple"]}, prf=True, prf_posterior="bogus")
