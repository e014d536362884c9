"""Real-index integration tests against the checked-in Brown Indri index.

Ports the reference's DiskIndex assertions (data_tests.cpp:595-679): exact
document-id mappings, corpus size, and decoded n-gram strings from a binary
index artifact produced by Indri itself — the deepest independent check on
the data layer.
"""

import os

import numpy as np
import pytest

from cunvsm.config import DataConfig
from cunvsm.data.corpus import load_corpus
from cunvsm.data.indri import (
    IndriIndex,
    build_corpus_from_indri,
    is_indri_repository,
)

BROWN = "/root/reference/test_data/Brown_index"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(BROWN), reason="Brown index not available"
)


def _cfg(**kw):
    defaults = dict(
        corpus_path=BROWN,
        max_vocabulary_size=0,
        min_document_frequency=0,
        max_document_frequency=0,
        include_oov=False,
        include_digits=False,
        documents_cutoff=0,
    )
    defaults.update(kw)
    return DataConfig(**defaults)


@pytest.fixture(scope="module")
def index():
    return IndriIndex(BROWN)


def test_manifest_statistics(index):
    # data_tests.cpp Brown: corpus_size 500; index/0/manifest values.
    assert index.document_count == 500
    assert index.document_base == 1
    assert index.maximum_document == 501
    assert index.total_terms == 1032531
    assert index.unique_terms == 29980
    assert index.frequent_count == 10


def test_document_lengths_sum_to_total_terms(index):
    assert index.document_lengths.shape == (500,)
    assert int(index.document_lengths.sum()) == index.total_terms


def test_term_list_consistency(index):
    # Per-document statistics must agree with the decoded term list:
    # total length including stopped positions, indexed length excluding
    # them, and the unique count over indexed terms.
    for doc_id in (1, 250, 500):
        tl = index.term_list(doc_id)
        rec = index._doc_stats[doc_id - index.document_base]
        assert len(tl) == index.document_length(doc_id)
        assert int((tl != 0).sum()) == rec["indexed_length"]
        assert len(np.unique(tl[tl != 0])) == rec["unique_terms"]


def test_vocabulary_statistics_match_direct_index(index):
    # TermData cf/df must equal frequencies recounted from the term lists.
    from collections import Counter

    cf = Counter()
    df = Counter()
    for doc_id in range(index.document_base, index.maximum_document):
        tl = index.term_list(doc_id)
        ids = np.unique(tl[tl != 0])
        for t in tl[tl != 0].tolist():
            cf[t] += 1
        for t in ids.tolist():
            df[t] += 1
    vocab = index.vocabulary()
    assert len(vocab) == index.unique_terms
    by_id = {e.term_id: e for e in vocab}
    # Frequent ids are 1..frequent_count; infrequent ids alphabetical + 10.
    for tid in list(cf)[:200] + [1, 2, 10, 11, index.unique_terms]:
        e = by_id[tid]
        assert e.total_count == cf[tid], (tid, e)
        assert e.document_count == df[tid], (tid, e)
    assert sum(e.total_count for e in vocab) == int(
        (np.concatenate([index.term_list(d) for d in range(1, 501)]) != 0).sum()
    )


def test_docno_mappings(index):
    docnos = index.docnos()
    assert len(docnos) == 500
    assert docnos[1] == "ca01"
    assert docnos[500] == docnos[max(docnos)]
    # Round trip through the reverse lookup.
    sample = [docnos[i] for i in (1, 42, 330, 500)]
    assert index.docids_from_docnos(sample) == [1, 42, 330, 500]


def test_document_list_mapping():
    # data_tests.cpp:595-622 (IndriSourceTest.document_list): model ids in
    # list order, mapped to these exact Indri document ids.
    document_list = ["cj36", "ck17", "cn04", "cg62", "cm02"]
    corpus = build_corpus_from_indri(
        BROWN, _cfg(), 3, document_list=document_list,
    )
    assert corpus.num_docs == 5
    index = IndriIndex(BROWN)
    expected = {0: 330, 1: 391, 2: 437, 3: 251, 4: 429}
    ids = index.docids_from_docnos(corpus.docnos)
    assert {m: i for m, i in enumerate(ids)} == expected


def test_brown_full_corpus_and_ngram_strings():
    # data_tests.cpp:624-679 (IndriSourceTest.Brown): all 500 documents map
    # 1:1 (model id i -> Indri id i+1, none shorter than the window), and
    # decoded windows read as real stemmed/stopped Brown text.
    corpus = build_corpus_from_indri(BROWN, _cfg(), 16)
    assert corpus.num_docs == 500
    index = IndriIndex(BROWN)
    ids = index.docids_from_docnos(corpus.docnos)
    assert ids == list(range(1, 501))

    # Document 0 begins with the famous Brown ca01 sentence, Krovetz-stemmed
    # with stopwords removed.
    d0 = corpus.tokens[corpus.doc_offsets[0]:corpus.doc_offsets[1]]
    head = " ".join(corpus.vocab.terms[t] for t in d0[:12])
    assert head == (
        "fulton county grand jury friday investigate atlanta recent "
        "primary election produce evidence"
    )
    # Index lengths are the Indri document lengths (include stopped slots).
    assert corpus.index_lengths[0] == 2032
    assert int(corpus.index_lengths.sum()) == index.total_terms


def test_vocab_filtering_rules():
    # Digit terms dropped by default; df bounds honoured.
    corpus = build_corpus_from_indri(BROWN, _cfg(), 16)
    assert all(not t or not t[0].isdigit() or not t.replace(".", "").isdigit()
               for t in corpus.vocab.terms)
    cfg = _cfg(min_document_frequency=5, max_document_frequency=100,
               max_vocabulary_size=1000)
    small = build_corpus_from_indri(BROWN, cfg, 16)
    assert small.vocab.size <= 1000
    index = IndriIndex(BROWN)
    by_term = {e.term: e for e in index.vocabulary()}
    for t in small.vocab.terms:
        if t:
            assert 5 <= by_term[t].document_count <= 100


def test_load_corpus_dispatch():
    assert is_indri_repository(BROWN)
    corpus = load_corpus(_cfg(), window_size=16)
    assert corpus.num_docs == 500


def test_real_index_term_ids_in_metadata():
    # index_term_ids must be the REAL Indri ids (pyndri interop), not
    # synthesized first-occurrence ranks.
    corpus = build_corpus_from_indri(BROWN, _cfg(), 16)
    index = IndriIndex(BROWN)
    by_term = {e.term: e.term_id for e in index.vocabulary()}
    for model_id in (0, 1, len(corpus.vocab.terms) - 1):
        term = corpus.vocab.terms[model_id]
        if term:
            assert corpus.vocab.index_term_ids[model_id] == by_term[term]


def test_training_smoke_on_brown():
    # End-to-end: instances generate and a train step runs on the real index.
    from cunvsm.config import ModelDesc, TrainConfig
    from cunvsm.data.instances import TextEntitySource
    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import init_params
    from cunvsm.optim.updates import Optimizer
    from cunvsm.train.step import make_train_step
    import jax
    import jax.numpy as jnp

    corpus = build_corpus_from_indri(BROWN, _cfg(max_vocabulary_size=2000), 8)
    cfg = TrainConfig(batch_size=256, window_size=8, num_random_entities=2)
    src = TextEntitySource(corpus, batch_size=cfg.batch_size, seed=1)
    batch = next(iter(src.epoch_batches()))
    desc = ModelDesc(word_repr_size=16, entity_repr_size=16)
    params = init_params(
        jax.random.PRNGKey(0), corpus.vocab.size, corpus.num_docs, desc
    )
    opt = Optimizer(cfg)
    step = make_train_step(desc, cfg)
    jb = TextEntityBatch(
        *[None if x is None else jnp.asarray(x) for x in batch]
    )
    params, _, cost = step(params, opt.init(params), jb, jax.random.PRNGKey(1))
    assert np.isfinite(float(cost))


def test_metadata_carries_indri_document_ids():
    # ObjectInfo.index_object_id must be the real Indri document id
    # (data_indri.cpp:557-571), not the model id.
    from cunvsm.io.checkpoint import build_metadata

    document_list = ["cj36", "cg62"]
    corpus = build_corpus_from_indri(
        BROWN, _cfg(), 3, document_list=document_list
    )
    meta = build_metadata(
        corpus.vocab.index_term_ids,
        corpus.vocab.term_freq,
        corpus.num_docs,
        corpus.vocab.total_terms,
        corpus.vocab.include_oov,
        index_object_ids=corpus.index_doc_ids,
    )
    assert [(o.model_object_id, o.index_object_id) for o in meta.object] == [
        (0, 330), (1, 251),
    ]


def test_vendored_stoplist_matches_index_stopper():
    """The vendored Lemur stoplist must equal the stopper block recorded in
    the checked-in Brown index manifest (the same stoplist.dft the
    reference's build_index downloads, functions.sh:344-350)."""
    from cunvsm.data.indri import IndriIndex
    from cunvsm.data.text import lemur_stopwords

    idx = IndriIndex(BROWN)
    assert lemur_stopwords() == idx.stopwords
