"""Training-loop finite-difference gradient checks.

The reference's gradient_checking_tests.cu:68-334 doesn't check a single
batch at init: it runs full training loops (tests_base_cuda.h:132-194) in
which *every* batch's analytic gradient is verified against central finite
differences over every parameter, across seeds x model descs x update
methods — catching state-dependent gradient bugs (batch norm over evolved
statistics, L2 normalizers near small norms, optimizer-evolved params at
saturation) that a single check at initialization cannot.

Like the reference (:62-67), the loop grid avoids gradient kinks: tanh
nonlinearity (hard-tanh's clip boundary breaks FD) and non-constant batch
data under batch normalization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import (
    AdamConfig,
    AdamMode,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm.models import objectives as obj
from cunvsm.models.params import ModelParams
from cunvsm.optim.updates import Optimizer
from cunvsm.train.gradcheck import check_gradients
from cunvsm.train.step import (
    ObjectiveKind,
    compute_cost_and_grads,
    scaled_regularization_lambda,
)

NUM_WORDS, NUM_ENTITIES, D_W, D_E = 7, 5, 3, 4
BATCH, WINDOW, NUM_NEG = 4, 2, 2
NUM_TRAIN_BATCHES = 4

# CLI spelling -> config, all five update methods (main.cu:479-485).
OPTIMIZERS = {
    "sgd": (UpdateMethod.SGD, None),
    "adagrad": (UpdateMethod.ADAGRAD, None),
    "sparse_adam": (UpdateMethod.ADAM, AdamMode.SPARSE),
    "dense_adam": (UpdateMethod.ADAM, AdamMode.DENSE_UPDATE),
    "full_adam": (UpdateMethod.ADAM, AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
}

# Adagrad and SPARSE-mode Adam reject multiple sparse descriptors, exactly
# like the reference (CHECK_EQ at updates_adagrad.cu:108); composite
# objectives produce two descriptors for one table.
SINGLE_DESC_ONLY = {"adagrad", "sparse_adam"}

DESCS = {
    "plain": ModelDesc(nonlinearity=Nonlinearity.TANH),
    "batchnorm": ModelDesc(
        nonlinearity=Nonlinearity.TANH, batch_normalization=True
    ),
    "l2norms": ModelDesc(
        nonlinearity=Nonlinearity.TANH,
        l2_normalize_phrase_reprs=True,
        l2_normalize_entity_reprs=True,
    ),
}


def make_params(seed):
    rng = np.random.RandomState(seed)
    return ModelParams(
        word_reprs=jnp.asarray(0.5 * rng.randn(NUM_WORDS, D_W)),
        entity_reprs=jnp.asarray(0.5 * rng.randn(NUM_ENTITIES, D_E)),
        transform_w=jnp.asarray(0.5 * rng.randn(D_W, D_E)),
        transform_b=jnp.asarray(0.1 * rng.randn(D_E)),
    )


def make_te_batch(rng):
    return obj.TextEntityBatch(
        features=jnp.asarray(
            rng.randint(0, NUM_WORDS, (BATCH, WINDOW)), dtype=jnp.int32
        ),
        feature_weights=jnp.asarray(rng.rand(BATCH, WINDOW) + 0.5),
        labels=jnp.asarray(rng.randint(0, NUM_ENTITIES, (BATCH,)), jnp.int32),
        weights=jnp.asarray(rng.rand(BATCH) + 0.5),
    )


def make_sim_batch(rng, num_objects):
    return obj.SimilarityBatch(
        ids=jnp.asarray(rng.randint(0, num_objects, (BATCH, 2)), jnp.int32),
        weights=jnp.asarray(rng.rand(BATCH) + 0.5),
    )


def make_batch(kind, rng):
    if kind == ObjectiveKind.TEXT_ENTITY:
        return make_te_batch(rng)
    if kind == ObjectiveKind.ENTITY_ENTITY:
        return make_sim_batch(rng, NUM_ENTITIES)
    if kind == ObjectiveKind.TERM_TERM:
        return make_sim_batch(rng, NUM_WORDS)
    if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        return (make_te_batch(rng), make_sim_batch(rng, NUM_ENTITIES))
    return (make_te_batch(rng), make_sim_batch(rng, NUM_WORDS))


def make_cfg(kind, method, adam_mode):
    kw = dict(
        batch_size=BATCH,
        window_size=WINDOW,
        num_random_entities=NUM_NEG,
        update_method=method,
        adam=AdamConfig(mode=adam_mode) if adam_mode else AdamConfig(),
        regularization_lambda=0.01,
    )
    if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        kw.update(text_entity_weight=0.7, entity_entity_weight=0.3)
    elif kind == ObjectiveKind.TEXT_ENTITY_TERM_TERM:
        kw.update(text_entity_weight=0.6, term_term_weight=0.4)
    return TrainConfig(**kw)


def train_with_gradient_checks(kind, desc, cfg, seed):
    """The ModelTest::train(check_gradients=true) analog
    (tests_base_cuda.h:132-194): N optimizer steps, each batch FD-checked
    against the state the update will consume."""
    params = make_params(seed)
    optimizer = Optimizer(cfg)
    opt_state = optimizer.init(params)
    lr = cfg.resolved_learning_rate()
    lam = scaled_regularization_lambda(cfg, kind)
    rng = np.random.RandomState(seed + 1000)

    for step_idx in range(NUM_TRAIN_BATCHES):
        batch = make_batch(kind, rng)
        key = jax.random.PRNGKey(seed * 100 + step_idx)
        n, max_err = check_gradients(kind, params, batch, key, desc, cfg)
        assert n > 0 and np.isfinite(max_err)
        _, grads = compute_cost_and_grads(kind, params, batch, key, desc, cfg)
        params, opt_state = optimizer.apply(
            params, opt_state, grads, lr, lam
        )
        assert all(
            np.all(np.isfinite(np.asarray(leaf)))
            for leaf in jax.tree_util.tree_leaves(params)
        )
    return params


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("desc_name", sorted(DESCS))
def test_text_entity_training_loop(opt_name, desc_name):
    method, mode = OPTIMIZERS[opt_name]
    kind = ObjectiveKind.TEXT_ENTITY
    train_with_gradient_checks(
        kind, DESCS[desc_name], make_cfg(kind, method, mode), seed=1
    )


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize(
    "kind", [ObjectiveKind.ENTITY_ENTITY, ObjectiveKind.TERM_TERM]
)
def test_similarity_training_loop(opt_name, kind):
    method, mode = OPTIMIZERS[opt_name]
    train_with_gradient_checks(
        kind, DESCS["plain"], make_cfg(kind, method, mode), seed=2
    )


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize(
    "kind",
    [
        ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY,
        ObjectiveKind.TEXT_ENTITY_TERM_TERM,
    ],
)
def test_composite_training_loop(opt_name, kind):
    method, mode = OPTIMIZERS[opt_name]
    cfg = make_cfg(kind, method, mode)
    if opt_name in SINGLE_DESC_ONLY:
        # Reference parity: these modes CHECK-fail on multiple descriptors.
        with pytest.raises(AssertionError, match="multiple gradients"):
            train_with_gradient_checks(kind, DESCS["plain"], cfg, seed=3)
        return
    train_with_gradient_checks(kind, DESCS["plain"], cfg, seed=3)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_text_entity_full_adam_seeds(seed):
    """Seed sweep on the canonical optimizer (6-seed protocol analog,
    gradient_checking_tests.cu:68)."""
    kind = ObjectiveKind.TEXT_ENTITY
    method, mode = OPTIMIZERS["full_adam"]
    train_with_gradient_checks(
        kind, DESCS["batchnorm"], make_cfg(kind, method, mode), seed=seed
    )
