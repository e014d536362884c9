"""Query engine, metrics, fusion, and TREC IO tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cunvsm.io.trec import read_qrels, read_run, read_topics, write_run
from cunvsm.models.params import ModelParams
from cunvsm.query.engine import QueryEngine
from cunvsm.query.fusion import compute_combined_run, fuse_fixed_alpha
from cunvsm.query.metrics import (
    average_precision,
    evaluate_run,
    ndcg_at,
    precision_at,
)


def make_engine(nonlinearity="tanh", **kw):
    rng = np.random.RandomState(0)
    params = ModelParams(
        word_reprs=jnp.asarray(rng.randn(6, 4)),
        entity_reprs=jnp.asarray(rng.randn(5, 3)),
        transform_w=jnp.asarray(rng.randn(4, 3)),
        transform_b=jnp.asarray(rng.randn(3)),
    )
    terms = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    docnos = [f"d{i}" for i in range(5)]
    return (
        QueryEngine(params, terms, docnos, nonlinearity=nonlinearity, **kw),
        params,
    )


class TestQueryEngine:
    def test_query_representation_mean(self):
        eng, params = make_engine()
        r = eng.query_representation(["alpha", "gamma"])
        w = np.asarray(params.word_reprs)
        np.testing.assert_allclose(r, (w[0] + w[2]) / 2, rtol=1e-12)

    def test_oov_terms_skipped(self):
        eng, params = make_engine()
        r = eng.query_representation(["alpha", "UNKNOWN"])
        np.testing.assert_allclose(
            r, np.asarray(params.word_reprs)[0], rtol=1e-12
        )
        assert eng.query_representation(["NOPE"]) is None

    def test_rank_matches_numpy_cosine(self):
        # The on-device matmul + top_k must reproduce the reference's
        # sklearn cosine ranking (base.py:362-430).
        eng, params = make_engine()
        out = eng.rank({"q1": ["alpha", "beta"]}, top_k=5)
        r = eng.query_representation(["alpha", "beta"])
        proj = np.tanh(
            r @ np.asarray(params.transform_w)
        )  # bias_coefficient=0 -> no bias
        proj = proj / np.linalg.norm(proj)
        E = np.asarray(params.entity_reprs)
        E = E / np.linalg.norm(E, axis=1, keepdims=True)
        want = np.argsort(-(E @ proj))
        got = [int(d[1:]) for d, _ in out["q1"]]
        np.testing.assert_array_equal(got, want)

    def test_linear_mode(self):
        # NVSM is queried with --linear (functions.sh:269-271).
        eng, params = make_engine(nonlinearity=None)
        out = eng.rank({"q": ["beta"]}, top_k=2)
        r = np.asarray(params.word_reprs)[1]
        proj = r @ np.asarray(params.transform_w)
        proj = proj / np.linalg.norm(proj)
        E = np.asarray(params.entity_reprs)
        E = E / np.linalg.norm(E, axis=1, keepdims=True)
        want_top = int(np.argmax(E @ proj))
        assert out["q"][0][0] == f"d{want_top}"

    def test_score_documents_subset(self):
        eng, _ = make_engine()
        full = eng.rank({"q": ["alpha"]}, top_k=5)["q"]
        sub = eng.score_documents(["alpha"], ["d1", "d3"])
        full_scores = dict(full)
        assert {d for d, _ in sub} == {"d1", "d3"}
        for d, s in sub:
            np.testing.assert_allclose(s, full_scores[d], rtol=1e-5)

    def test_related_terms_and_similarity(self):
        eng, params = make_engine()
        rel = eng.related_terms("alpha", k=3)
        assert len(rel) == 3 and all(t != "alpha" for t, _ in rel)
        sim = eng.term_similarity("alpha", "beta")
        w = np.asarray(params.word_reprs)
        want = w[0] @ w[1] / (np.linalg.norm(w[0]) * np.linalg.norm(w[1]))
        np.testing.assert_allclose(sim, want, rtol=1e-5)


class TestMetrics:
    def test_average_precision(self):
        ranked = [("a", 3.0), ("b", 2.0), ("c", 1.0)]
        rels = {"a": 1, "c": 1, "x": 1}
        # hits at ranks 1 and 3; 3 relevant total.
        want = (1 / 1 + 2 / 3) / 3
        np.testing.assert_allclose(average_precision(ranked, rels), want)

    def test_no_relevant_returns_none(self):
        assert average_precision([("a", 1.0)], {"a": 0}) is None

    def test_precision_and_ndcg(self):
        ranked = [("a", 3.0), ("b", 2.0)]
        rels = {"a": 1}
        assert precision_at(ranked, rels, 2) == 0.5
        assert ndcg_at(ranked, rels, 2) == 1.0  # ideal: rel doc first

    def test_evaluate_run(self):
        run = {"q1": [("a", 2.0), ("b", 1.0)]}
        qrels = {"q1": {"b": 1}, "q2": {"z": 1}}
        m = evaluate_run(run, qrels, measures=("map",))
        # q1 AP = 1/2; q2 has no retrieved docs -> AP 0.
        np.testing.assert_allclose(m["map"], (0.5 + 0.0) / 2)


class TestTrecIO:
    def test_run_roundtrip(self, tmp_path):
        run = {"q1": [("d2", 0.9), ("d1", 0.5)], "q2": [("d3", 1.0)]}
        p = str(tmp_path / "run.txt")
        write_run(run, p, name="test")
        loaded = read_run(p)
        assert loaded["q1"][0] == ("d2", 0.9)
        with open(p) as f:
            first = f.readline().split()
        assert first[:4] == ["q1", "Q0", "d2", "1"]

    def test_qrels(self, tmp_path):
        p = tmp_path / "qrels"
        p.write_text("1 0 d1 1\n1 0 d2 0\n2 0 d3 2\n")
        q = read_qrels(str(p))
        assert q["1"]["d1"] == 1 and q["2"]["d3"] == 2

    def test_topics_sgml(self, tmp_path):
        p = tmp_path / "topics"
        p.write_text(
            "<top>\n<num> 001 </num>\n<title> airplane wings </title>\n</top>"
        )
        t = read_topics(str(p))
        assert t == {"001": "airplane wings"}


class TestFusion:
    def test_combined_is_mean_of_weighted_norms(self):
        # combine_runs.py:15-34: mean over the runs that retrieved the doc.
        run_a = {"q": [("d1", 10.0), ("d2", 0.0)]}
        run_b = {"q": [("d1", 1.0), ("d3", 0.0)]}
        out = compute_combined_run(
            [run_a, run_b], [0.5, 0.5], ["q"], normalizer="minmax"
        )
        scores = dict(out["q"])
        # d1: mean(0.5*1, 0.5*1) = 0.5 ; d2: mean(0.5*0)=0 ; d3: 0.
        np.testing.assert_allclose(scores["d1"], 0.5)
        np.testing.assert_allclose(scores["d2"], 0.0)

    def test_fixed_alpha_union_of_queries(self):
        run_a = {"q1": [("d1", 1.0)]}
        run_b = {"q2": [("d2", 1.0)]}
        out = fuse_fixed_alpha(run_a, run_b, 0.5, normalizer="none")
        assert set(out.keys()) == {"q1", "q2"}


class TestQueryExtras:
    def test_l2norm_phrase(self):
        eng, params = make_engine(l2norm_phrase=True)
        r = eng.query_representation(["alpha", "gamma"])
        np.testing.assert_allclose(np.linalg.norm(r), 1.0, rtol=1e-12)

    def test_term_bruteforcer(self):
        from cunvsm.query.engine import TermBruteforcer

        eng, params = make_engine()
        bf = TermBruteforcer(eng, max_ngram_cardinality=1)
        # The nearest n-gram to a term's own projection is that term.
        target = eng.infer(np.asarray(params.word_reprs)[2])  # "gamma"
        top = bf.nearest_ngrams(target, k=1)
        assert top[0][0] == ("gamma",)

    def test_term_bruteforcer_full_vocabulary(self):
        """Cardinality 1 covers EVERY vocabulary term regardless of
        max_terms (the reference brute-forces all 1-grams,
        py/nvsm/base.py:106-162); the cap applies only to cardinality>=2
        combinations."""
        from cunvsm.query.engine import TermBruteforcer

        eng, params = make_engine()
        vocab = len(eng.term_to_id)
        bf = TermBruteforcer(eng, max_ngram_cardinality=1, max_terms=2)
        assert len(bf.ngrams) == vocab
        # Every term's own projection is its nearest 1-gram.
        for tid, term in enumerate(sorted(
            eng.term_to_id, key=eng.term_to_id.get
        )):
            target = eng.infer(np.asarray(params.word_reprs)[tid])
            assert bf.nearest_ngrams(target, k=1)[0][0] == (term,)

    def test_term_bruteforcer_cardinality2_cap(self):
        from cunvsm.query.engine import TermBruteforcer

        eng, params = make_engine()
        vocab = len(eng.term_to_id)
        bf = TermBruteforcer(eng, max_ngram_cardinality=2, max_terms=3)
        # Full vocab 1-grams + C(3,2) capped 2-grams.
        assert len(bf.ngrams) == vocab + 3
        w = np.asarray(params.word_reprs)
        pair = next(g for g in bf.ngrams if len(g) == 2)
        ids = [eng.term_to_id[t] for t in pair]
        target = eng.infer(w[ids].mean(axis=0))
        assert bf.nearest_ngrams(target, k=1)[0][0] == pair

    def test_tfidf_rank(self):
        from cunvsm.config import DataConfig
        from cunvsm.data.corpus import build_corpus
        from cunvsm.query.qlm import build_qlm_index, tfidf_rank

        docs = [("d0", "apple apple banana"), ("d1", "banana cherry"),
                ("d2", "cherry cherry cherry")]
        corpus = build_corpus(
            docs,
            DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                       max_document_frequency=0),
            window_size=1,
        )
        idx = build_qlm_index(corpus)
        ranked = tfidf_rank(idx, ["apple"])
        assert [d for d, _ in ranked] == ["d0"]  # only exact matches appear
        ranked = tfidf_rank(idx, ["cherry"])
        assert ranked[0][0] == "d2"

    def test_bf16_score_dtype_ranks_consistently(self):
        eng32, _ = make_engine()
        eng16, _ = make_engine(score_dtype=jnp.bfloat16)
        r32 = eng32.rank({"q": ["alpha", "beta"]}, top_k=5)["q"]
        r16 = eng16.rank({"q": ["alpha", "beta"]}, top_k=5)["q"]
        # Identical top-5 sets on well-separated random vectors.
        assert [d for d, _ in r32] == [d for d, _ in r16]

    def test_bf16_subset_consistent_with_rank(self):
        # score_documents must quantize like the device kernel so subset
        # scores match rank() at bf16 too.
        eng16, _ = make_engine(score_dtype=jnp.bfloat16)
        full = dict(eng16.rank({"q": ["alpha"]}, top_k=5)["q"])
        sub = eng16.score_documents(["alpha"], ["d1", "d3"])
        for d, s in sub:
            np.testing.assert_allclose(s, full[d], rtol=1e-5)


class TestCrossValidatedFusion:
    def test_cv_alpha_search_prefers_better_run(self):
        from cunvsm.query.fusion import fuse_cross_validated

        # run_good ranks the relevant doc first for every query; run_bad is
        # inverted.  CV fusion should learn alpha weighting run_good high and
        # produce near-perfect fused rankings on held-out folds.
        qrels = {f"q{i}": {"rel": 1, "irr": 0} for i in range(10)}
        run_good = {f"q{i}": [("rel", 2.0), ("irr", 1.0)] for i in range(10)}
        run_bad = {f"q{i}": [("irr", 2.0), ("rel", 1.0)] for i in range(10)}
        fused = fuse_cross_validated(
            run_good, run_bad, qrels, num_folds=5, alpha_stepsize=0.25,
            normalizer="minmax",
        )
        assert set(fused) == set(qrels)
        from cunvsm.query.metrics import evaluate_run

        m = evaluate_run(fused, qrels, measures=("map",))
        assert m["map"] == 1.0

    def test_cv_grid_single_variant_matches_cv(self):
        # With exactly one lexical candidate the grid protocol degenerates
        # to fuse_cross_validated (same folds, same alpha grid, same
        # tie-break), so the fused runs must be identical.
        from cunvsm.query.fusion import (
            fuse_cross_validated,
            fuse_cross_validated_grid,
        )

        rng = np.random.RandomState(7)
        docs = [f"d{i}" for i in range(12)]
        qrels = {
            f"q{i}": {d: int(rng.rand() < 0.3) for d in docs}
            for i in range(9)
        }
        def rand_run():
            return {
                q: sorted(
                    ((d, float(rng.randn())) for d in docs),
                    key=lambda x: -x[1],
                )
                for q in qrels
            }

        run_a, run_b = rand_run(), rand_run()
        ref = fuse_cross_validated(
            run_a, run_b, qrels, num_folds=4, alpha_stepsize=0.2
        )
        got, selections = fuse_cross_validated_grid(
            run_a, {"only": run_b}, qrels, num_folds=4, alpha_stepsize=0.2
        )
        assert got == ref
        assert {s["lexical"] for s in selections} == {"only"}

    def test_cv_grid_selects_better_variant(self):
        from cunvsm.query.fusion import fuse_cross_validated_grid
        from cunvsm.query.metrics import evaluate_run

        qrels = {f"q{i}": {"rel": 1, "irr": 0} for i in range(10)}
        run_a = {f"q{i}": [("irr", 2.0), ("rel", 1.0)] for i in range(10)}
        good = {f"q{i}": [("rel", 2.0), ("irr", 1.0)] for i in range(10)}
        bad = {f"q{i}": [("irr", 2.0), ("rel", 1.0)] for i in range(10)}
        fused, selections = fuse_cross_validated_grid(
            run_a, {"good": good, "bad": bad}, qrels,
            num_folds=5, alpha_stepsize=0.25, normalizer="minmax",
        )
        assert all(s["lexical"] == "good" for s in selections)
        assert evaluate_run(fused, qrels, measures=("map",))["map"] == 1.0

    def test_recall_metric(self):
        from cunvsm.query.metrics import recall_at

        ranked = [("a", 3.0), ("b", 2.0), ("c", 1.0)]
        rels = {"a": 1, "c": 1, "z": 1}
        assert recall_at(ranked, rels, 1) == 1 / 3
        assert recall_at(ranked, rels, 3) == 2 / 3
        assert recall_at(ranked, {}, 3) is None
