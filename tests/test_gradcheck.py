"""End-to-end finite-difference gradient checks for all five objectives.

The analog of gradient_checking_tests.cu: every analytic gradient
(including the sparse descriptor scatters) is verified against central finite
differences over every parameter, in float64 on CPU, across the reference's
model-desc grid (seeds x nonlinearity x BN x L2-norm x bias_negative_samples,
gradient_checking_tests.cu:68-334).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import ModelDesc, Nonlinearity, TrainConfig
from cunvsm.models import objectives as obj
from cunvsm.models.params import ModelParams
from cunvsm.train.gradcheck import check_gradients
from cunvsm.train.step import ObjectiveKind

NUM_WORDS, NUM_ENTITIES, D_W, D_E = 7, 5, 3, 4
BATCH, WINDOW, NUM_NEG = 4, 2, 2


def make_params(seed):
    rng = np.random.RandomState(seed)
    return ModelParams(
        word_reprs=jnp.asarray(rng.randn(NUM_WORDS, D_W)),
        entity_reprs=jnp.asarray(rng.randn(NUM_ENTITIES, D_E)),
        transform_w=jnp.asarray(rng.randn(D_W, D_E)),
        transform_b=jnp.asarray(rng.randn(D_E)),
    )


def make_te_batch(seed):
    rng = np.random.RandomState(seed + 100)
    return obj.TextEntityBatch(
        features=jnp.asarray(
            rng.randint(0, NUM_WORDS, (BATCH, WINDOW)), dtype=jnp.int32
        ),
        feature_weights=jnp.asarray(rng.rand(BATCH, WINDOW) + 0.5),
        labels=jnp.asarray(rng.randint(0, NUM_ENTITIES, (BATCH,)), jnp.int32),
        weights=jnp.asarray(rng.rand(BATCH) + 0.5),
    )


def make_sim_batch(seed, num_objects):
    rng = np.random.RandomState(seed + 200)
    return obj.SimilarityBatch(
        ids=jnp.asarray(rng.randint(0, num_objects, (BATCH, 2)), jnp.int32),
        weights=jnp.asarray(rng.rand(BATCH) + 0.5),
    )


CONFIG_GRID = [
    # gradient_checking_tests.cu:74-111 model-desc grid.
    ModelDesc(nonlinearity=Nonlinearity.TANH),
    ModelDesc(nonlinearity=Nonlinearity.HARD_TANH),
    ModelDesc(nonlinearity=Nonlinearity.TANH, bias_negative_samples=True),
    ModelDesc(nonlinearity=Nonlinearity.TANH, l2_normalize_phrase_reprs=True),
    ModelDesc(nonlinearity=Nonlinearity.TANH, l2_normalize_entity_reprs=True),
    ModelDesc(
        nonlinearity=Nonlinearity.TANH,
        l2_normalize_phrase_reprs=True,
        l2_normalize_entity_reprs=True,
    ),
    ModelDesc(nonlinearity=Nonlinearity.TANH, batch_normalization=True),
    ModelDesc(nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True),
    ModelDesc(nonlinearity=Nonlinearity.TANH, clip_sigmoid=False),
]


def _base_cfg():
    return TrainConfig(
        batch_size=BATCH, window_size=WINDOW, num_random_entities=NUM_NEG
    )


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("desc_idx", range(len(CONFIG_GRID)))
def test_text_entity_gradients(seed, desc_idx):
    desc = CONFIG_GRID[desc_idx]
    n, max_err = check_gradients(
        ObjectiveKind.TEXT_ENTITY,
        make_params(seed),
        make_te_batch(seed),
        jax.random.PRNGKey(seed),
        desc,
        _base_cfg(),
    )
    assert n == NUM_WORDS * D_W + NUM_ENTITIES * D_E + D_W * D_E + D_E


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize(
    "kind", [ObjectiveKind.ENTITY_ENTITY, ObjectiveKind.TERM_TERM]
)
def test_similarity_gradients(seed, kind):
    num_objects = (
        NUM_ENTITIES if kind == ObjectiveKind.ENTITY_ENTITY else NUM_WORDS
    )
    check_gradients(
        kind,
        make_params(seed),
        make_sim_batch(seed, num_objects),
        jax.random.PRNGKey(seed),
        ModelDesc(),
        _base_cfg(),
    )


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize(
    "kind",
    [
        ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY,
        ObjectiveKind.TEXT_ENTITY_TERM_TERM,
    ],
)
def test_composite_gradients(seed, kind):
    # Mixture weighting as set by main.cu:698-706.
    if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY:
        cfg = TrainConfig(
            batch_size=BATCH,
            window_size=WINDOW,
            num_random_entities=NUM_NEG,
            text_entity_weight=0.7,
            entity_entity_weight=0.3,
        )
        num_objects = NUM_ENTITIES
    else:
        cfg = TrainConfig(
            batch_size=BATCH,
            window_size=WINDOW,
            num_random_entities=NUM_NEG,
            text_entity_weight=0.6,
            term_term_weight=0.4,
        )
        num_objects = NUM_WORDS
    batch = (make_te_batch(seed), make_sim_batch(seed, num_objects))
    check_gradients(
        kind,
        make_params(seed),
        batch,
        jax.random.PRNGKey(seed),
        ModelDesc(),
        cfg,
    )


def test_duplicate_indices_accumulate():
    """Duplicate word/entity ids within a batch must sum their gradients
    (atomicAdd semantics, storage.cu:37-49; model_tests.cu:153-244)."""
    params = make_params(0)
    batch = obj.TextEntityBatch(
        features=jnp.array([[2, 2], [2, 2]], dtype=jnp.int32),
        feature_weights=jnp.ones((2, 2)),
        labels=jnp.array([1, 1], dtype=jnp.int32),
        weights=jnp.ones((2,)),
    )
    cfg = TrainConfig(batch_size=2, window_size=2, num_random_entities=NUM_NEG)
    check_gradients(
        ObjectiveKind.TEXT_ENTITY,
        params,
        batch,
        jax.random.PRNGKey(0),
        ModelDesc(),
        cfg,
    )


def test_padded_batch_zero_weight_instances():
    """Zero-weight (padding) instances must contribute nothing to cost or
    gradients (pad_remainder contract)."""
    params = make_params(1)
    full = make_te_batch(1)
    padded = obj.TextEntityBatch(
        features=jnp.concatenate([full.features,
                                  jnp.zeros((2, WINDOW), jnp.int32)]),
        feature_weights=jnp.concatenate([full.feature_weights,
                                         jnp.zeros((2, WINDOW))]),
        labels=jnp.concatenate([full.labels, jnp.zeros((2,), jnp.int32)]),
        weights=jnp.concatenate([full.weights, jnp.zeros((2,))]),
    )
    desc = ModelDesc()
    ids_full = obj.sample_negative_entities(
        jax.random.PRNGKey(0), full.labels, NUM_ENTITIES, NUM_NEG
    )
    ids_pad = jnp.concatenate(
        [ids_full, jnp.zeros((2, NUM_NEG + 1), jnp.int32)]
    )
    # Same normalizer (the padded batch uses the real-count normalizer).
    c_full, _, g_full = obj.text_entity_cost_and_grads(
        params, full, ids_full, desc, batch_size_normalizer=BATCH
    )
    c_pad, _, g_pad = obj.text_entity_cost_and_grads(
        params, padded, ids_pad, desc, batch_size_normalizer=BATCH
    )
    np.testing.assert_allclose(float(c_full), float(c_pad), rtol=1e-10)
    from cunvsm.train.gradcheck import densify_grads

    d_full = densify_grads(params, g_full)
    d_pad = densify_grads(params, g_pad)
    for a, b in zip(d_full, d_pad):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-12
        )


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize(
    "desc",
    [
        ModelDesc(nonlinearity=Nonlinearity.TANH),
        ModelDesc(nonlinearity=Nonlinearity.HARD_TANH,
                  batch_normalization=True),
        ModelDesc(nonlinearity=Nonlinearity.TANH,
                  l2_normalize_phrase_reprs=True,
                  bias_negative_samples=True),
    ],
)
def test_shared_negatives_gradients_through_training(seed, desc):
    """FD-check the shared-negatives hand-VJP on evolved parameter states:
    a few full_adam training steps with every batch's analytic gradients
    verified against central differences (the reference's training-loop
    protocol, gradient_checking_tests.cu:68-334)."""
    import dataclasses

    from cunvsm.config import AdamConfig, AdamMode, UpdateMethod
    from cunvsm.optim.updates import Optimizer
    from cunvsm.train.step import make_train_step

    cfg = dataclasses.replace(
        _base_cfg(),
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=0.05,
        regularization_lambda=0.01,
        shared_negatives=True,
    )
    params = make_params(seed)
    opt = Optimizer(cfg)
    opt_state = opt.init(params)
    step = make_train_step(desc, cfg, jit=False)
    key = jax.random.PRNGKey(seed)
    for i in range(3):
        key, bkey, skey = jax.random.split(key, 3)
        batch = make_te_batch(seed * 10 + i)
        check_gradients(
            ObjectiveKind.TEXT_ENTITY, params, batch, skey, desc, cfg
        )
        params, opt_state, cost = step(params, opt_state, batch, skey)
        assert np.isfinite(float(cost))


@pytest.mark.parametrize(
    "kind",
    [
        ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY,
        ObjectiveKind.TEXT_ENTITY_TERM_TERM,
    ],
)
def test_composite_gradients_with_pooled_negatives(kind):
    """Mix 'n Match composites with the rolled-pool text-entity constituent:
    the merged ascent gradients must match finite differences of the
    weight-normalized composite objective."""
    import dataclasses

    desc = ModelDesc(nonlinearity=Nonlinearity.TANH)
    cfg = dataclasses.replace(
        _base_cfg(),
        negative_pool_size=4,
        text_entity_weight=0.5,
        entity_entity_weight=(
            0.5 if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY else 0.0
        ),
        term_term_weight=(
            0.5 if kind == ObjectiveKind.TEXT_ENTITY_TERM_TERM else 0.0
        ),
    )
    num_objects = (
        NUM_ENTITIES
        if kind == ObjectiveKind.TEXT_ENTITY_ENTITY_ENTITY
        else NUM_WORDS
    )
    batch = (make_te_batch(4), make_sim_batch(4, num_objects))
    check_gradients(
        kind, make_params(4), batch, jax.random.PRNGKey(4), desc, cfg
    )
