"""End-to-end integration: corpus -> train -> checkpoint -> query -> eval.

The minimum end-to-end slice of SURVEY.md §7: a small synthetic collection
with clear topical structure, trained with the LSE-style config, checkpointed
in the reference HDF5 format, then ranked by the on-device query engine and
scored with MAP.
"""

import logging

import numpy as np
import pytest

from cunvsm.config import (
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm.data.corpus import build_corpus
from cunvsm.data.sources import SimilaritySource
from cunvsm.io import checkpoint as ckpt
from cunvsm.query.engine import QueryEngine, load_query_engine
from cunvsm.query.metrics import evaluate_run
from cunvsm.train.trainer import train_model

TOPICS = {
    "space": "rocket orbit launch satellite astronaut mission gravity".split(),
    "cooking": "recipe oven flour butter bake sugar yeast".split(),
    "sports": "goal match player referee score stadium league".split(),
}


def synthetic_corpus(num_docs_per_topic=6, doc_len=30, seed=0):
    rng = np.random.RandomState(seed)
    docs = []
    labels = {}
    common = "the and with from this that".split()
    for topic, words in TOPICS.items():
        for i in range(num_docs_per_topic):
            body = [
                words[rng.randint(len(words))]
                if rng.rand() < 0.7
                else common[rng.randint(len(common))]
                for _ in range(doc_len)
            ]
            docno = f"{topic}_{i}"
            docs.append((docno, " ".join(body)))
            labels[docno] = topic
    return docs, labels


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    docs, labels = synthetic_corpus()
    data_cfg = DataConfig(
        max_vocabulary_size=0, min_document_frequency=0, max_document_frequency=0
    )
    corpus = build_corpus(docs, data_cfg, window_size=4)
    desc = ModelDesc(
        word_repr_size=24,
        entity_repr_size=16,
        nonlinearity=Nonlinearity.TANH,
        bias_negative_samples=True,  # the LSE preset (functions.sh:263-271)
    )
    cfg = TrainConfig(
        num_epochs=30,
        batch_size=32,
        window_size=4,
        num_random_entities=5,
        learning_rate=0.01,
        regularization_lambda=0.01,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=1,
    )
    prefix = str(tmp_path_factory.mktemp("ckpt") / "model")
    result = train_model(
        desc, cfg, corpus, output_prefix=prefix, dump_initial_model=True
    )
    return corpus, labels, result, prefix, cfg


def test_cost_decreases(trained):
    _, _, result, _, cfg = trained
    costs = result.epoch_costs
    assert len(costs) == cfg.num_epochs
    assert costs[-1] < 0.6 * costs[0]
    assert all(np.isfinite(c) for c in costs)


def test_checkpoints_written(trained):
    corpus, _, _, prefix, cfg = trained
    import h5py, os

    assert os.path.exists(f"{prefix}_0.hdf5")  # dump_initial_model
    with h5py.File(f"{prefix}_{cfg.num_epochs}.hdf5", "r") as f:
        assert f["word_representations-representations"].shape == (
            corpus.vocab.size,
            24,
        )
    meta = ckpt.load_meta(prefix)
    assert meta.total_terms == corpus.vocab.total_terms
    assert len(meta.object) == corpus.num_docs


def test_retrieval_quality(trained):
    corpus, labels, result, prefix, cfg = trained
    engine = load_query_engine(prefix, cfg.num_epochs, nonlinearity="tanh")

    queries = {t: words[:3] for t, words in TOPICS.items()}
    run = engine.rank(queries, top_k=len(corpus.docnos))
    qrels = {
        t: {d: int(labels[d] == t) for d in corpus.docnos} for t in TOPICS
    }
    metrics = evaluate_run(run, qrels, measures=("map", "p_10"))
    # With clearly separated topics the model must rank same-topic docs
    # near the top (random MAP would be ~0.33 with 6/18 relevant).
    assert metrics["map"] > 0.8, metrics


def test_resume_continues(trained, tmp_path):
    corpus, _, result, prefix, cfg = trained
    # Resume from the saved state and train one more epoch.
    cfg2 = TrainConfig(**{**cfg.__dict__, "num_epochs": cfg.num_epochs + 1})
    desc = ModelDesc(
        word_repr_size=24,
        entity_repr_size=16,
        nonlinearity=Nonlinearity.TANH,
        bias_negative_samples=True,
    )
    result2 = train_model(
        desc, cfg2, corpus, output_prefix=prefix, resume=True
    )
    assert len(result2.epoch_costs) == 1  # only the extra epoch ran
    assert np.isfinite(result2.epoch_costs[0])


def test_resume_equals_uninterrupted(tmp_path):
    """2+2 epochs with resume must produce exactly the params of an
    uninterrupted 4-epoch run (instance stream + per-step PRNG keys both
    continue where they left off)."""
    docs, _ = synthetic_corpus(num_docs_per_topic=3, doc_len=20)
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)

    def cfg(n):
        return TrainConfig(
            num_epochs=n, batch_size=8, window_size=4,
            num_random_entities=2, learning_rate=0.01, seed=3,
        )

    straight = train_model(desc, cfg(4), corpus)

    prefix = str(tmp_path / "m")
    train_model(desc, cfg(2), corpus, output_prefix=prefix)
    resumed = train_model(
        desc, cfg(4), corpus, output_prefix=prefix, resume=True
    )

    for a, b in zip(straight.params, resumed.params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_resume_equals_uninterrupted_on_device_sampling(tmp_path):
    """Resume determinism on the epoch-exact on-device path: the per-epoch
    permutation key derives from the epoch index and the per-step keys from
    the step counter, so 2+2 epochs must equal an uninterrupted 4."""
    docs, _ = synthetic_corpus(num_docs_per_topic=3, doc_len=20)
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)

    def cfg(n):
        return TrainConfig(
            num_epochs=n, batch_size=8, window_size=4,
            num_random_entities=2, learning_rate=0.01, seed=3,
        )

    straight = train_model(
        desc, cfg(4), corpus, on_device_sampling=True, steps_per_call=2
    )

    prefix = str(tmp_path / "m")
    train_model(
        desc, cfg(2), corpus, output_prefix=prefix,
        on_device_sampling=True, steps_per_call=2,
    )
    resumed = train_model(
        desc, cfg(4), corpus, output_prefix=prefix, resume=True,
        on_device_sampling=True, steps_per_call=2,
    )

    for a, b in zip(straight.params, resumed.params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_resume_equals_uninterrupted_on_mesh(tmp_path):
    """Resume determinism on the sharded path (entity padding + sharded
    opt state must round-trip through the resume file)."""
    from cunvsm.parallel.mesh import make_mesh

    docs, _ = synthetic_corpus(num_docs_per_topic=3, doc_len=20)
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)

    def cfg(n):
        return TrainConfig(
            num_epochs=n, batch_size=8, window_size=4,
            num_random_entities=2, learning_rate=0.01, seed=3,
        )

    straight = train_model(desc, cfg(4), corpus, mesh=make_mesh(2, 4))

    prefix = str(tmp_path / "m")
    train_model(desc, cfg(2), corpus, output_prefix=prefix,
                mesh=make_mesh(2, 4))
    resumed = train_model(desc, cfg(4), corpus, output_prefix=prefix,
                          resume=True, mesh=make_mesh(2, 4))

    for a, b in zip(straight.params, resumed.params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_resume_equals_uninterrupted_composite(tmp_path):
    """Resume determinism with a Mix 'n Match similarity stream: the
    repeating similarity source must fast-forward past the consumed
    batches so 2+2 epochs equals 4 straight."""
    docs, _ = synthetic_corpus(num_docs_per_topic=3, doc_len=20)
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    rng = np.random.RandomState(9)
    pairs = rng.randint(0, corpus.num_docs, (10, 2)).astype(np.int32)
    weights = np.ones(10, np.float32)

    def cfg(n):
        return TrainConfig(
            num_epochs=n, batch_size=8, window_size=4,
            num_random_entities=2, learning_rate=0.01, seed=3,
            text_entity_weight=0.7, entity_entity_weight=0.3,
        )

    def sim():
        return SimilaritySource(pairs, weights, batch_size=8,
                                drop_remainder=False)

    straight = train_model(desc, cfg(4), corpus, similarity_source=sim())

    prefix = str(tmp_path / "m")
    train_model(desc, cfg(2), corpus, output_prefix=prefix,
                similarity_source=sim())
    resumed = train_model(desc, cfg(4), corpus, output_prefix=prefix,
                          resume=True, similarity_source=sim())

    for a, b in zip(straight.params, resumed.params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_resume_equals_uninterrupted_pooled_negatives(tmp_path):
    """Resume determinism with rolled-pool negatives: the per-step pool is
    drawn from the same step-derived key on replay."""
    docs, _ = synthetic_corpus(num_docs_per_topic=3, doc_len=20)
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=4,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)

    def cfg(n):
        return TrainConfig(
            num_epochs=n, batch_size=8, window_size=4,
            num_random_entities=2, learning_rate=0.01, seed=3,
            negative_pool_size=4,
        )

    straight = train_model(desc, cfg(4), corpus)

    prefix = str(tmp_path / "m")
    train_model(desc, cfg(2), corpus, output_prefix=prefix)
    resumed = train_model(
        desc, cfg(4), corpus, output_prefix=prefix, resume=True
    )

    for a, b in zip(straight.params, resumed.params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )
