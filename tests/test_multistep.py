"""Multi-step scan training tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import DataConfig, ModelDesc, TrainConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.models import objectives as obj
from cunvsm.models.params import init_params
from cunvsm.optim.updates import Optimizer
from cunvsm.train.step import make_multistep_train_step, make_train_step
from cunvsm.train.trainer import train_model


def test_multistep_equals_chained_single_steps():
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = TrainConfig(batch_size=8, window_size=3, num_random_entities=2)
    params = init_params(jax.random.PRNGKey(0), 20, 10, desc)
    opt_state = Optimizer(cfg).init(params)

    rng = np.random.RandomState(0)
    K = 4
    batches = obj.TextEntityBatch(
        features=jnp.asarray(rng.randint(0, 20, (K, 8, 3)), jnp.int32),
        feature_weights=jnp.ones((K, 8, 3)),
        labels=jnp.asarray(rng.randint(0, 10, (K, 8)), jnp.int32),
        weights=jnp.ones((K, 8)),
    )
    key = jax.random.PRNGKey(5)

    single = make_train_step(desc, cfg, jit=False)
    p, o = params, opt_state
    keys = jax.random.split(key, K)
    single_costs = []
    for i in range(K):
        b = jax.tree_util.tree_map(lambda x: x[i], batches)
        p, o, c = single(p, o, b, keys[i])
        single_costs.append(float(c))

    # multistep donates its inputs; run it after the reference chain.
    multi = make_multistep_train_step(desc, cfg, K)
    p_multi, _, costs = multi(params, opt_state, batches, key)

    np.testing.assert_allclose(np.asarray(costs), single_costs, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(p_multi.word_reprs), np.asarray(p.word_reprs), rtol=1e-5
    )


def test_trainer_steps_per_call():
    docs = [
        (f"d{i}", " ".join(f"w{j}" for j in
                           np.random.RandomState(i).randint(0, 20, 20)))
        for i in range(8)
    ]
    corpus = build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=3,
    )
    desc = ModelDesc(word_repr_size=8, entity_repr_size=6)
    cfg = TrainConfig(
        num_epochs=3, batch_size=8, window_size=3, num_random_entities=2,
        learning_rate=0.01,
    )
    result = train_model(desc, cfg, corpus, steps_per_call=4)
    assert len(result.epoch_costs) == 3
    assert all(np.isfinite(c) for c in result.epoch_costs)
