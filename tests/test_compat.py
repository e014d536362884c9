"""Tests for the py/nvsm-compatible API shim."""

import numpy as np
import pytest

from cunvsm.compat import nvsm
from cunvsm.config import DataConfig, ModelDesc, TrainConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.train.trainer import train_model


@pytest.fixture(scope="module")
def model_prefix(tmp_path_factory):
    rng = np.random.RandomState(0)
    topics = {
        "space": "rocket orbit launch satellite astronaut".split(),
        "food": "recipe oven flour butter bake".split(),
    }
    docs = []
    for t, words in topics.items():
        for i in range(5):
            body = " ".join(words[rng.randint(len(words))] for _ in range(20))
            docs.append((f"{t}_{i}", body))
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=16, entity_repr_size=12)
    cfg = TrainConfig(
        num_epochs=10, batch_size=16, window_size=4, num_random_entities=3,
        learning_rate=0.01, seed=1,
    )
    prefix = str(tmp_path_factory.mktemp("compat") / "m")
    train_model(desc, cfg, corpus, output_prefix=prefix)
    return prefix, corpus


def test_load_and_attributes(model_prefix):
    prefix, corpus = model_prefix
    meta = nvsm.load_meta(prefix)
    model = nvsm.load_model(meta, prefix, 10)
    assert model.num_terms == corpus.vocab.size
    assert model.num_objects == corpus.num_docs
    assert model.word_representations.shape == (corpus.vocab.size, 16)
    assert model.transform_matrix.shape == (16, 12)
    assert "NVSM" in repr(model)
    assert nvsm.LSE is nvsm.NVSM


def test_query_representation_and_infer(model_prefix):
    prefix, corpus = model_prefix
    meta = nvsm.load_meta(prefix)
    model = nvsm.load_model(meta, prefix, 10)
    # Address terms by index term id, like pyndri-based callers do.
    rocket_model_id = corpus.vocab.term_to_id["rocket"]
    rocket_index_id = int(corpus.vocab.index_term_ids[rocket_model_id])
    r = model.query_representation([rocket_index_id])
    np.testing.assert_allclose(
        r, model.word_representations[rocket_model_id], rtol=1e-6
    )
    proj = model.infer(r)
    assert proj.shape == (12,)
    assert model.query_representation([999999]) is None


def test_query_ranks_topically(model_prefix):
    prefix, corpus = model_prefix
    meta = nvsm.load_meta(prefix)
    model = nvsm.load_model(meta, prefix, 10, nonlinearity="tanh")
    t2i = corpus.vocab.term_to_id
    iids = [
        int(corpus.vocab.index_term_ids[t2i[t]]) for t in ("rocket", "orbit")
    ]
    ranked = model.query(iids, top_k=5)
    assert len(ranked) == 5
    # Top document is a space doc: map index_object_id -> docno.
    top_obj = ranked[0][0]
    model_doc = model.inv_object_mapping[top_obj]
    assert corpus.docnos[model_doc].startswith("space")


def test_related_terms_and_similarity(model_prefix):
    prefix, corpus = model_prefix
    meta = nvsm.load_meta(prefix)
    model = nvsm.load_model(meta, prefix, 10)
    t2i = corpus.vocab.term_to_id
    iid = int(corpus.vocab.index_term_ids[t2i["rocket"]])
    rel = model.related_terms(iid, k=3)
    assert len(rel) == 3
    sim = model.term_similarity(
        iid, int(corpus.vocab.index_term_ids[t2i["orbit"]])
    )
    assert -1.0 <= sim <= 1.0


# ---------------------------------------------------------------------------
# Executed interop with the REFERENCE'S OWN loader (py/nvsm/base.py).
# ---------------------------------------------------------------------------


def _import_reference_nvsm():
    """Import the actual /root/reference/py/nvsm/base.py module.

    Its two non-public dependencies are satisfied the way a downstream user
    would: ``nvsm_pb2`` resolves to this framework's generated protobuf
    module (the wire contract under test), and the tiny
    ``cvangysel.sklearn_utils.neighbors_algorithm`` helper is stubbed to
    sklearn's 'brute' algorithm (its only role is picking an ANN algorithm).
    """
    import importlib.util
    import os
    import sys
    import types

    base_path = "/root/reference/py/nvsm/base.py"
    if not os.path.exists(base_path):
        pytest.skip("reference checkout not available")
    if "cvangysel.sklearn_utils" not in sys.modules:
        pkg = types.ModuleType("cvangysel")
        sk = types.ModuleType("cvangysel.sklearn_utils")
        sk.neighbors_algorithm = lambda metric: "brute"
        pkg.sklearn_utils = sk
        sys.modules["cvangysel"] = pkg
        sys.modules["cvangysel.sklearn_utils"] = sk
    if "nvsm_pb2" not in sys.modules:
        from cunvsm.proto import nvsm_pb2

        sys.modules["nvsm_pb2"] = nvsm_pb2
    spec = importlib.util.spec_from_file_location(
        "reference_nvsm_base", base_path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_loader_executes_on_repo_checkpoint(model_prefix):
    """The reference's py/nvsm/base.py:13-24 loader, executed unmodified,
    must read a checkpoint written by this framework: same shapes, same
    mappings, and query_representation/infer/query parity with
    cunvsm.compat.nvsm — converting "wire-compatible by construction"
    into "wire-compatible, demonstrated"."""
    prefix, corpus = model_prefix
    ref = _import_reference_nvsm()

    ref_meta = ref.load_meta(prefix)
    ref_model = ref.load_model(ref_meta, prefix, 10)
    ours = nvsm.load_model(nvsm.load_meta(prefix), prefix, 10)

    # Tables and mappings.
    assert ref_model.num_terms == ours.num_terms
    assert ref_model.num_objects == ours.num_objects
    np.testing.assert_array_equal(
        ref_model.word_representations, ours.word_representations
    )
    np.testing.assert_array_equal(
        ref_model.object_representations, ours.object_representations
    )
    np.testing.assert_array_equal(
        ref_model.transform_matrix, ours.transform_matrix
    )
    assert ref_model.term_mapping == ours.term_mapping
    assert ref_model.object_mapping == ours.object_mapping
    assert (
        ref_model.inv_term_id_to_term_freq == ours.inv_term_id_to_term_freq
    )
    assert ref_model.total_terms == ours.total_terms

    # query_representation / infer parity on an in-vocabulary query.
    t2i = corpus.vocab.term_to_id
    iids = [
        int(corpus.vocab.index_term_ids[t2i[t]]) for t in ("rocket", "orbit")
    ]
    qr_ref = ref_model.query_representation(iids)
    qr_ours = ours.query_representation(iids)
    np.testing.assert_allclose(qr_ref, qr_ours, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        ref_model.infer(qr_ref), ours.infer(qr_ours), rtol=1e-5, atol=1e-6
    )
    assert ref_model.query_representation([999999]) is None

    # Full ranking parity: the reference returns (cosine_distance,
    # index_object_id) ascending; ours returns (index_object_id,
    # cosine_similarity) descending.  Compare over ALL documents with
    # deterministic tie-free assertions on the scores.
    n_docs = ref_model.num_objects
    ranked_ref = ref_model.query(iids, results_requested=n_docs)
    ranked_ours = ours.query(iids, top_k=n_docs)
    assert len(ranked_ref) == len(ranked_ours) == n_docs
    ref_scores = {obj: 1.0 - dist for dist, obj in ranked_ref}
    our_scores = dict(ranked_ours)
    assert set(ref_scores) == set(our_scores)
    for obj in ref_scores:
        np.testing.assert_allclose(
            ref_scores[obj], our_scores[obj], rtol=1e-4, atol=1e-5
        )
    # Top document agrees exactly.
    assert ranked_ref[0][1] == ranked_ours[0][0]

    # Subset scoring through the reference's document_set branch
    # (base.py:404-424; its score_documents method asserts a (1, d)
    # query_representation its own query_representation never produces, so
    # the document_set path is the one reference callers can reach).
    subset = [obj for _, obj in ranked_ref[:5]]
    # Custom similarity_fn (a documented reference API): today's scipy
    # rejects the 2-D vector the reference passes to
    # scipy.spatial.distance.cosine, so ravel inside the callable.
    import scipy.spatial.distance as _ssd

    ref_sub = {
        obj: 1.0 - dist
        for dist, obj in ref_model.query_using_projected_query(
            ref_model.infer(qr_ref),
            document_set=subset,
            similarity_fn=lambda first, second, int_obj_id: _ssd.cosine(
                np.ravel(first), np.ravel(second)
            ),
        )
    }
    ours_sub = dict(ours.score_documents(iids, subset))
    assert set(ref_sub) == set(ours_sub)
    for obj in ref_sub:
        np.testing.assert_allclose(
            ref_sub[obj], ours_sub[obj], rtol=1e-4, atol=1e-5
        )


def test_reference_self_information_weights(model_prefix):
    """The reference's self-information weighting path (base.py:293-309)
    consumes the term_frequency/total_terms fields of our _meta."""
    prefix, corpus = model_prefix
    ref = _import_reference_nvsm()
    ref_model = ref.load_model(
        ref.load_meta(prefix), prefix, 10, self_information=True
    )
    ours = nvsm.load_model(
        nvsm.load_meta(prefix), prefix, 10, self_information=True
    )
    t2i = corpus.vocab.term_to_id
    iids = [
        int(corpus.vocab.index_term_ids[t2i[t]])
        for t in ("rocket", "orbit", "launch")
    ]
    np.testing.assert_allclose(
        ref_model.query_representation(iids),
        ours.query_representation(iids),
        rtol=1e-6,
        atol=1e-7,
    )
