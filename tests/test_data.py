"""Data-pipeline tests (data_tests.cpp analog, minus Indri)."""

import numpy as np
import pytest

from cunvsm.config import DataConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.data.instances import (
    FeatureWeighting,
    TextEntitySource,
    Weighting,
)
from cunvsm.data.sources import (
    Prefetcher,
    SimilaritySource,
    load_similarities,
    repeating,
    zip_sources,
)
from cunvsm.data.text import is_number, iter_trectext, tokenize
from cunvsm.data.vocab import build_vocabulary


def default_cfg(**kw):
    base = dict(
        max_vocabulary_size=0,
        min_document_frequency=0,
        max_document_frequency=0,
        include_oov=False,
        include_digits=False,
    )
    base.update(kw)
    return DataConfig(**base)


class TestTokenize:
    def test_lowercase_alnum(self):
        assert tokenize("Hello, World! x2") == ["hello", "world", "x2"]

    def test_stopwords(self):
        assert tokenize("the cat sat", frozenset(["the"])) == ["cat", "sat"]

    def test_is_number(self):
        assert is_number("42") and is_number("3.14") and not is_number("x1")


class TestTrectext:
    def test_parse(self, tmp_path):
        p = tmp_path / "docs.trectext"
        p.write_text(
            "<DOC>\n<DOCNO> d1 </DOCNO>\n<TEXT>\nalpha beta\n</TEXT>\n</DOC>\n"
            "<DOC>\n<DOCNO>d2</DOCNO>\n<TITLE>gamma</TITLE>"
            "<TEXT>delta</TEXT>\n</DOC>\n"
        )
        docs = list(iter_trectext(str(p)))
        assert [d for d, _ in docs] == ["d1", "d2"]
        assert tokenize(docs[0][1]) == ["alpha", "beta"]
        # Content outside <TEXT> (e.g. titles) is included, tags stripped.
        assert tokenize(docs[1][1]) == ["gamma", "delta"]


class TestVocabulary:
    DOCS = [
        "a a a b b c dd dd dd dd".split(),
        "a b c c dd 42".split(),
        "a zz".split(),
    ]

    def test_frequency_order_ids(self):
        # Model ids ascend by (collection frequency, first-occurrence id)
        # (min-heap pop order, data_indri.cpp:825-856).
        v = build_vocabulary(self.DOCS, default_cfg())
        # cf: a=5, b=3, c=3, dd=5, zz=1, 42 dropped (digit).
        # sorted by (freq, index id): zz(1), b(3), c(3), a(5), dd(5)
        assert v.terms == ["zz", "b", "c", "a", "dd"]
        np.testing.assert_array_equal(v.term_freq, [1, 3, 3, 5, 5])
        assert v.total_terms == 17

    def test_max_vocabulary_keeps_most_frequent(self):
        v = build_vocabulary(self.DOCS, default_cfg(max_vocabulary_size=2))
        assert set(v.terms) == {"a", "dd"}

    def test_df_filters(self):
        v = build_vocabulary(
            self.DOCS, default_cfg(min_document_frequency=2)
        )
        assert "zz" not in v.terms
        v = build_vocabulary(
            self.DOCS, default_cfg(max_document_frequency=2)
        )
        assert "a" not in v.terms  # df(a)=3 > 2

    def test_relative_max_df(self):
        # max_df <= 1.0 is a corpus fraction (main.cu:665-677):
        # ceil(3 * 0.5) = 2.
        v = build_vocabulary(
            self.DOCS, default_cfg(max_document_frequency=0.5)
        )
        assert "a" not in v.terms and "b" in v.terms

    def test_digits_toggle(self):
        v = build_vocabulary(self.DOCS, default_cfg(include_digits=True))
        assert "42" in v.terms

    def test_blacklist(self):
        v = build_vocabulary(
            self.DOCS, default_cfg(), term_blacklist=frozenset(["dd"])
        )
        assert "dd" not in v.terms

    def test_oov_slot(self):
        v = build_vocabulary(self.DOCS, default_cfg(include_oov=True))
        assert v.terms[0] == "" and v.term_freq[0] == 1
        assert v.term_to_id["zz"] == 1

    def test_subset_frequencies(self):
        # Frequencies restricted to kept docs; vanished terms dropped
        # (data_indri.cpp:592-618,838-846).
        v = build_vocabulary(self.DOCS, default_cfg(), kept_docs=[0, 1])
        assert "zz" not in v.terms
        assert v.term_freq[v.term_to_id["a"]] == 4

    def test_self_information(self):
        v = build_vocabulary(self.DOCS, default_cfg())
        si = v.self_information()
        a = v.term_to_id["a"]
        np.testing.assert_allclose(si[a], -np.log(5 / 17))


class TestCorpus:
    def docs(self):
        return [
            ("d0", "apple banana cherry durian elder"),
            ("d1", "fig grape"),  # shorter than window -> dropped
            ("d2", "apple apple banana banana cherry cherry"),
        ]

    def test_short_docs_dropped(self):
        c = build_corpus(self.docs(), default_cfg(), window_size=3)
        assert c.docnos == ["d0", "d2"]
        assert c.num_docs == 2

    def test_packing(self):
        c = build_corpus(self.docs(), default_cfg(), window_size=3)
        d0 = c.tokens[c.doc_offsets[0] : c.doc_offsets[1]]
        words = [c.vocab.terms[i] for i in d0]
        assert words == ["apple", "banana", "cherry", "durian", "elder"]

    def test_oov_dropped_vs_kept(self):
        cfg = default_cfg(min_document_frequency=2)
        c = build_corpus(self.docs(), cfg, window_size=3)
        # durian/elder have df 1 -> OOV -> dropped from token stream.
        assert c.doc_lengths[0] == 3
        assert c.index_lengths[0] == 5

        cfg = default_cfg(min_document_frequency=2, include_oov=True)
        c = build_corpus(self.docs(), cfg, window_size=3)
        assert c.doc_lengths[0] == 5
        d0 = c.tokens[c.doc_offsets[0] : c.doc_offsets[1]]
        assert (d0 == 0).sum() == 2  # two OOV positions


class TestInstances:
    def corpus(self):
        docs = [
            ("d0", "a b c d e f"),
            ("d1", "g h i j"),
        ]
        return build_corpus(docs, default_cfg(), window_size=3)

    def test_sequential_windows(self):
        # Stride-1 windows (create_instances, data.h:236-273 /
        # data_indri.cpp:180-218): doc0 has 4, doc1 has 2.
        src = TextEntitySource(
            self.corpus(), batch_size=6, shuffle=False, drop_remainder=False
        )
        batches = list(src.epoch_batches())
        assert len(batches) == 1
        b = batches[0]
        assert b.features.shape == (6, 3)
        np.testing.assert_array_equal(b.labels, [0, 0, 0, 0, 1, 1])
        # First window of doc0 is tokens [a b c].
        terms = [self.corpus().vocab.terms[i] for i in b.features[0]]
        assert terms == ["a", "b", "c"]

    def test_sequential_inv_doc_frequency_weights(self):
        src = TextEntitySource(
            self.corpus(), batch_size=6, shuffle=False, drop_remainder=False
        )
        b = next(src.epoch_batches())
        avg = (6 + 4) / 2
        np.testing.assert_allclose(b.weights[0], avg / 6, rtol=1e-6)
        np.testing.assert_allclose(b.weights[4], avg / 4, rtol=1e-6)

    def test_stochastic_counts_and_shuffle(self):
        c = self.corpus()
        src = TextEntitySource(c, batch_size=4, shuffle=True, seed=3)
        # samples/doc = max(ceil(avg_len - w + 1), 1) = ceil(5-3+1) = 3.
        assert src.instances_per_epoch() == 2 * 3
        b1 = list(src.epoch_batches())
        b2 = list(src.epoch_batches())
        assert len(b1) == 1  # 6 instances, batch 4, drop remainder -> 1
        # Weights uniform in stochastic mode.
        np.testing.assert_array_equal(b1[0].weights, np.ones(4))
        # Epochs differ (reshuffled positions).
        assert not np.array_equal(b1[0].features, b2[0].features)

    def test_windows_stay_in_document(self):
        c = self.corpus()
        src = TextEntitySource(c, batch_size=6, shuffle=True, seed=0,
                               drop_remainder=False)
        for b in src.epoch_batches():
            for i in range(len(b.labels)):
                doc = b.labels[i]
                lo, hi = c.doc_offsets[doc], c.doc_offsets[doc + 1]
                toks = c.tokens[lo:hi]
                # Window must be a contiguous slice of the doc.
                window = b.features[i]
                found = any(
                    np.array_equal(toks[p : p + 3], window)
                    for p in range(len(toks) - 2)
                )
                assert found

    def test_self_information_feature_weights(self):
        c = self.corpus()
        src = TextEntitySource(
            c,
            batch_size=6,
            shuffle=False,
            feature_weighting=FeatureWeighting.SELF_INFORMATION,
            drop_remainder=False,
        )
        b = next(src.epoch_batches())
        si = c.vocab.self_information()
        np.testing.assert_allclose(
            b.feature_weights, si[b.features].astype(np.float32), rtol=1e-6
        )


class TestSimilaritySources:
    def test_load_and_join(self, tmp_path):
        p = tmp_path / "sims.txt"
        p.write_text("d0 d1 0.5\nd1 dX 1.0\nd2 d0 0.25\n")
        ids, w = load_similarities(str(p), {"d0": 0, "d1": 1, "d2": 2})
        # The pair with unknown member dX is skipped (data.cu:234-287).
        np.testing.assert_array_equal(ids, [[0, 1], [2, 0]])
        np.testing.assert_allclose(w, [0.5, 0.25])

    def test_epoch_shuffle_and_repeat(self):
        ids = np.arange(10, dtype=np.int32).reshape(5, 2)
        w = np.ones(5, np.float32)
        src = SimilaritySource(ids, w, batch_size=2, seed=0)
        stream = repeating(src)
        seen = [next(stream) for _ in range(6)]
        assert all(b.ids.shape == (2, 2) for b in seen)

    def test_zip_paces_on_primary(self):
        primary = iter([1, 2, 3])
        secondary = iter(range(100))
        zipped = list(zip_sources(primary, secondary))
        assert len(zipped) == 3

    def test_prefetcher_order_and_errors(self):
        assert list(Prefetcher(iter(range(20)), depth=3)) == list(range(20))

        def boom():
            yield 1
            raise RuntimeError("stream failed")

        it = Prefetcher(boom())
        assert next(it) == 1
        with pytest.raises(RuntimeError):
            next(it)


class TestPackedCorpus:
    def test_save_load_roundtrip(self, tmp_path):
        docs = [("d0", "a b c d e"), ("d1", "c d e f g")]
        c = build_corpus(docs, default_cfg(), window_size=3)
        path = str(tmp_path / "packed")
        c.save(path)
        loaded = type(c).load(path)
        assert loaded.docnos == c.docnos
        assert loaded.vocab.terms == c.vocab.terms
        np.testing.assert_array_equal(loaded.tokens, c.tokens)
        np.testing.assert_array_equal(loaded.doc_offsets, c.doc_offsets)
        assert loaded.window_size == c.window_size
        assert loaded.vocab.total_terms == c.vocab.total_terms

    def test_load_corpus_npz_dispatch(self, tmp_path):
        from cunvsm.data.corpus import load_corpus

        docs = [("d0", "a b c d e"), ("d1", "c d e f g")]
        c = build_corpus(docs, default_cfg(), window_size=3)
        path = str(tmp_path / "packed.npz")
        c.save(path)
        cfg = DataConfig(corpus_path=path)
        loaded = load_corpus(cfg, 3)
        assert loaded.docnos == c.docnos
        import pytest as _pytest

        with _pytest.raises(ValueError):
            load_corpus(cfg, 5)


class TestPadRemainder:
    def test_pad_remainder_static_shapes(self):
        docs = [("d0", "a b c d e f"), ("d1", "g h i j")]
        c = build_corpus(docs, default_cfg(), window_size=3)
        src = TextEntitySource(
            c, batch_size=4, shuffle=False, pad_remainder=True
        )
        batches = list(src.epoch_batches())
        # 6 instances -> one full batch + one padded batch of 4.
        assert len(batches) == 2
        assert all(b.features.shape == (4, 3) for b in batches)
        # Padding rows carry zero weight; real rows keep theirs.
        assert np.all(batches[1].weights[:2] > 0)
        np.testing.assert_array_equal(batches[1].weights[2:], [0.0, 0.0])


class TestSkipEpochs:
    def test_resume_replays_same_stream(self):
        docs = [("d0", "a b c d e f g h i j"), ("d1", "k l m n o p")]
        c = build_corpus(docs, default_cfg(), window_size=3)
        # Uninterrupted: consume 3 epochs, record epoch 3.
        src = TextEntitySource(c, batch_size=4, shuffle=True, seed=7)
        for _ in range(2):
            list(src.epoch_batches())
        want = [b.features for b in src.epoch_batches()]
        # Resumed: skip 2 epochs, epoch 3 must match.
        src2 = TextEntitySource(c, batch_size=4, shuffle=True, seed=7)
        src2.skip_epochs(2)
        got = [b.features for b in src2.epoch_batches()]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
