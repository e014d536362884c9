"""Trainer auxiliary-option tests: gradient-check flow, logging, guards."""

import logging

import numpy as np
import pytest

from cunvsm.config import DataConfig, ModelDesc, TrainConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.train.trainer import train_model


def small_corpus(num_docs=4):
    docs = [
        (f"d{i}", " ".join(
            f"w{j}" for j in np.random.RandomState(i).randint(0, 12, 10)))
        for i in range(num_docs)
    ]
    return build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=3,
    )


def small_cfg(**kw):
    base = dict(
        num_epochs=1, batch_size=4, window_size=3, num_random_entities=2,
        learning_rate=0.01,
    )
    base.update(kw)
    return TrainConfig(**base)


def test_check_gradients_flow():
    """The --check_gradients training path verifies every batch's gradients
    before updating (main.cu:414-425 parity); float64 via the x64-enabled
    test env."""
    import jax.numpy as jnp

    corpus = small_corpus()
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    r = train_model(
        desc, small_cfg(), corpus, check_gradients=True, dtype=jnp.float64
    )
    assert np.isfinite(r.epoch_costs[0])


def test_log_every(caplog):
    corpus = small_corpus()
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    with caplog.at_level(logging.INFO, logger="cunvsm.train.trainer"):
        train_model(desc, small_cfg(), corpus, log_every=1)
    assert any("progress=" in m for m in caplog.messages)


def test_compute_initial_cost(caplog):
    corpus = small_corpus()
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    with caplog.at_level(logging.INFO, logger="cunvsm.train.trainer"):
        train_model(desc, small_cfg(), corpus, compute_initial_cost=True)
    assert any("Initial cost" in m for m in caplog.messages)


def test_incompatible_option_guards():
    corpus = small_corpus()
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    with pytest.raises(ValueError, match="steps_per_call"):
        train_model(
            desc, small_cfg(), corpus,
            check_gradients=True, steps_per_call=2,
        )
    with pytest.raises(ValueError, match="stochastic-only"):
        train_model(
            desc, small_cfg(no_shuffle=True), corpus,
            on_device_sampling=True,
        )
    with pytest.raises(ValueError, match="incompatible"):
        train_model(
            desc, small_cfg(), corpus,
            on_device_sampling=True, check_gradients=True,
        )


def test_on_device_steps_per_call_remainder_call(caplog):
    """A steps_per_call that does not divide the epoch's step count
    trains the remainder in one extra compiled call per epoch (with a
    warning) so no remainder steps are silently dropped and K keeps its
    requested size — the reference trains every instance each epoch
    (data_indri.cpp:224-410)."""
    corpus = small_corpus()
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    cfg = small_cfg(num_epochs=2)
    # 4 docs x ceil(10-3+1)=8 instances, batch 4 -> 8 steps/epoch; K=7
    # does not divide: 1 call of 7 + a remainder call of 1.
    with caplog.at_level(logging.INFO, logger="cunvsm.train.trainer"):
        r = train_model(
            desc, cfg, corpus, on_device_sampling=True, steps_per_call=7
        )
    assert any(
        "remainder steps run as one extra compiled call" in m
        for m in caplog.messages
    ), caplog.messages
    # Every epoch still trains the FULL 8 steps (7 + 1).
    assert sum("(8 steps" in m for m in caplog.messages) == 2
    assert np.isfinite(r.epoch_costs[-1])


def test_on_device_prime_step_count_keeps_call_size(caplog):
    """Prime epoch step counts must NOT collapse the call size to 1
    (the old largest-divisor fallback made every epoch dispatch-bound):
    K stays as requested and the remainder runs as one extra call."""
    corpus = small_corpus(num_docs=5)  # 5 docs x 8 instances, batch 8 -> 5
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    cfg = small_cfg(num_epochs=1, batch_size=8)
    with caplog.at_level(logging.INFO, logger="cunvsm.train.trainer"):
        r = train_model(
            desc, cfg, corpus, on_device_sampling=True, steps_per_call=3
        )
    # 5 steps/epoch = 1 call of 3 + remainder call of 2 — all 5 trained.
    assert sum("(5 steps" in m for m in caplog.messages) == 1
    assert np.isfinite(r.epoch_costs[-1])


def test_cross_chip_reduce_dtype_validated_at_config_time():
    with pytest.raises(ValueError, match="cross_chip_reduce_dtype"):
        TrainConfig(
            batch_size=4, window_size=3,
            cross_chip_reduce_dtype="bf16",
        ).resolved_cross_chip_reduce_dtype()
