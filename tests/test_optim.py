"""Closed-form optimizer tests (updates_tests.cu analog).

Every optimizer x {transform, representations} is checked against numpy
re-derivations of the exact reference update rules, over the same
hyperparameter grid spirit (lambda in {0, 0.1}, lr in {1.0, 0.5},
updates_tests.cu:28-32), including duplicate-index accumulation and
multi-step moment evolution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.config import (
    AdamConfig,
    AdamMode,
    TrainConfig,
    UpdateMethod,
)
from cunvsm.models.objectives import AscentGrads, SparseGrad
from cunvsm.models.params import ModelParams
from cunvsm.optim.updates import Optimizer

NUM_WORDS, NUM_ENTITIES, D_W, D_E = 6, 4, 3, 2


def make_params(seed=0, constant=None):
    rng = np.random.RandomState(seed)

    def mk(shape):
        if constant is not None:
            return jnp.full(shape, constant, dtype=jnp.float64)
        return jnp.asarray(rng.randn(*shape))

    return ModelParams(
        word_reprs=mk((NUM_WORDS, D_W)),
        entity_reprs=mk((NUM_ENTITIES, D_E)),
        transform_w=mk((D_W, D_E)),
        transform_b=mk((D_E,)),
    )


def make_grads(seed=0, window=2, num_instances=3):
    rng = np.random.RandomState(seed + 50)
    word_desc = SparseGrad(
        grad=jnp.asarray(rng.randn(num_instances, D_W)),
        # Deliberately include duplicate indices within and across windows.
        indices=jnp.asarray(
            rng.randint(0, NUM_WORDS, (num_instances, window)), jnp.int32
        ),
        weights=jnp.asarray(rng.rand(num_instances, window) + 0.5),
    )
    ent_desc = SparseGrad(
        grad=jnp.asarray(rng.randn(num_instances, D_E)),
        indices=jnp.asarray(
            rng.randint(0, NUM_ENTITIES, (num_instances, 1)), jnp.int32
        ),
        weights=None,
    )
    return AscentGrads(
        word=(word_desc,),
        entity=(ent_desc,),
        transform_w=jnp.asarray(rng.randn(D_W, D_E)),
        transform_b=jnp.asarray(rng.randn(D_E)),
    )


def np_scatter(table_shape, desc):
    """Dense accumulation of a sparse descriptor: out[idx[i,w]] += w_iw*g[i]."""
    out = np.zeros(table_shape)
    g = np.asarray(desc.grad)
    idx = np.asarray(desc.indices)
    w = np.asarray(desc.weights) if desc.weights is not None else np.ones_like(
        idx, dtype=np.float64
    )
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            out[idx[i, j]] += w[i, j] * g[i]
    return out


def cfg_for(method, mode=None, lr=0.5, lam=0.1):
    return TrainConfig(
        update_method=method,
        adam=AdamConfig(mode=mode) if mode else AdamConfig(),
        learning_rate=lr,
        regularization_lambda=lam,
    )


LAM_LR_GRID = [(0.0, 1.0), (0.1, 0.5)]


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_sgd(lam, lr):
    params, grads = make_params(), make_grads()
    opt = Optimizer(cfg_for(UpdateMethod.SGD, lr=lr, lam=lam))
    state = opt.init(params)
    new, _ = opt.apply(params, state, grads, lr, lam)

    # storage.cu:51-102 + storage_inl.h:8-32.
    want_w = np.asarray(params.word_reprs) * (1 - lam * lr) + lr * np_scatter(
        (NUM_WORDS, D_W), grads.word[0]
    )
    np.testing.assert_allclose(np.asarray(new.word_reprs), want_w, rtol=1e-12)

    want_e = np.asarray(params.entity_reprs) * (1 - lam * lr) + lr * np_scatter(
        (NUM_ENTITIES, D_E), grads.entity[0]
    )
    np.testing.assert_allclose(np.asarray(new.entity_reprs), want_e, rtol=1e-12)

    want_t = np.asarray(params.transform_w) * (1 - lam * lr) + lr * np.asarray(
        grads.transform_w
    )
    np.testing.assert_allclose(np.asarray(new.transform_w), want_t, rtol=1e-12)
    # Bias is never regularized (storage.cu:222-227).
    want_b = np.asarray(params.transform_b) + lr * np.asarray(grads.transform_b)
    np.testing.assert_allclose(np.asarray(new.transform_b), want_b, rtol=1e-12)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adagrad_transform(lam, lr):
    eps = 1e-6
    params, grads = make_params(), make_grads()
    opt = Optimizer(cfg_for(UpdateMethod.ADAGRAD, lr=lr, lam=lam))
    state = opt.init(params)
    new, new_state = opt.apply(params, state, grads, lr, lam)

    g = np.asarray(grads.transform_w)
    acc = g**2
    want = np.asarray(params.transform_w) * (1 - lam * lr) + lr * g / np.sqrt(
        acc + eps
    )
    np.testing.assert_allclose(np.asarray(new.transform_w), want, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(new_state.transform.acc_w), acc, rtol=1e-12
    )


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adagrad_representations(lam, lr):
    # updates_adagrad.cu:72-179: scalar-per-object accumulator fed with the
    # dim-averaged squared gradient; read back averaged over the window;
    # accumulator updated BEFORE the gradient scaling.
    eps = 1e-6
    params, grads = make_params(), make_grads()
    opt = Optimizer(cfg_for(UpdateMethod.ADAGRAD, lr=lr, lam=lam))
    state = opt.init(params)
    new, new_state = opt.apply(params, state, grads, lr, lam)

    desc = grads.word[0]
    g = np.asarray(desc.grad)
    idx = np.asarray(desc.indices)
    w = np.asarray(desc.weights)
    msq = np.mean(g**2, axis=1)
    acc = np.zeros(NUM_WORDS)
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            acc[idx[i, j]] += w[i, j] * msq[i]
    agg = np.array([acc[idx[i]].mean() for i in range(idx.shape[0])])
    g_scaled = g / np.sqrt(agg + eps)[:, None]
    scaled_desc = desc._replace(grad=jnp.asarray(g_scaled))
    want = np.asarray(params.word_reprs) * (1 - lam * lr) + lr * np_scatter(
        (NUM_WORDS, D_W), scaled_desc
    )
    np.testing.assert_allclose(np.asarray(new.word_reprs), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(new_state.word.acc), acc, rtol=1e-12)


def _np_adam_transform(p, g, m, v, t, lr, lam, beta1=0.9, beta2=0.999, eps=1e-6):
    g = g - lam * p
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g**2
    bc = np.sqrt(1 - beta2**t) / (1 - beta1**t)
    return p + lr * bc * m / (np.sqrt(v) + eps), m, v


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adam_transform_two_steps(lam, lr):
    params = make_params()
    opt = Optimizer(
        cfg_for(UpdateMethod.ADAM, AdamMode.DENSE_UPDATE_DENSE_VARIANCE, lr, lam)
    )
    state = opt.init(params)
    p = np.asarray(params.transform_w)
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    cur = params
    for t in (1, 2):
        grads = make_grads(seed=t)
        cur, state = opt.apply(cur, state, grads, lr, lam)
        p, m, v = _np_adam_transform(
            p, np.asarray(grads.transform_w), m, v, t, lr, lam
        )
        np.testing.assert_allclose(np.asarray(cur.transform_w), p, rtol=1e-10)
    assert int(state.transform.t) == 3


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adam_representations_sparse(lam, lr):
    # updates_adam.cu SPARSE mode: global moment decay + sparse additions,
    # scalar v, window-averaged statistics, eps OUTSIDE sqrt.
    beta1, beta2, eps = 0.9, 0.999, 1e-6
    params, grads = make_params(), make_grads()
    opt = Optimizer(cfg_for(UpdateMethod.ADAM, AdamMode.SPARSE, lr, lam))
    state = opt.init(params)
    new, new_state = opt.apply(params, state, grads, lr, lam)

    desc = grads.word[0]
    g = np.asarray(desc.grad)
    idx = np.asarray(desc.indices)
    m = (1 - beta1) * np_scatter((NUM_WORDS, D_W), desc)  # m0 = 0, decayed
    msq = np.mean(g**2, axis=1)
    v = np.zeros(NUM_WORDS)
    w = np.asarray(desc.weights)
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            v[idx[i, j]] += (1 - beta2) * w[i, j] * msq[i]
    bc = np.sqrt(1 - beta2) / (1 - beta1)
    agg_m = np.stack([m[idx[i]].mean(axis=0) for i in range(idx.shape[0])])
    agg_v = np.array([v[idx[i]].mean() for i in range(idx.shape[0])])
    step_g = bc * agg_m / (np.sqrt(agg_v)[:, None] + eps)
    want = np.asarray(params.word_reprs) * (1 - lam * lr) + lr * np_scatter(
        (NUM_WORDS, D_W), desc._replace(grad=jnp.asarray(step_g))
    )
    np.testing.assert_allclose(np.asarray(new.word_reprs), want, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(new_state.word.m), m, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(new_state.word.v), v, rtol=1e-12)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adam_representations_dense_update(lam, lr):
    # DENSE_UPDATE: sparse moments, dense parameter sweep -> rows never
    # touched by the batch still decay (quality-relevant, SURVEY.md §7).
    beta1, beta2, eps = 0.9, 0.999, 1e-6
    params, grads = make_params(), make_grads()
    opt = Optimizer(cfg_for(UpdateMethod.ADAM, AdamMode.DENSE_UPDATE, lr, lam))
    state = opt.init(params)
    new, _ = opt.apply(params, state, grads, lr, lam)

    desc = grads.word[0]
    m = (1 - beta1) * np_scatter((NUM_WORDS, D_W), desc)
    msq = np.mean(np.asarray(desc.grad) ** 2, axis=1)
    v = np.zeros(NUM_WORDS)
    idx = np.asarray(desc.indices)
    w = np.asarray(desc.weights)
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            v[idx[i, j]] += (1 - beta2) * w[i, j] * msq[i]
    bc = np.sqrt(1 - beta2) / (1 - beta1)
    want = np.asarray(params.word_reprs) * (1 - lam * lr) + lr * bc * m / (
        np.sqrt(v)[:, None] + eps
    )
    np.testing.assert_allclose(np.asarray(new.word_reprs), want, rtol=1e-10)


@pytest.mark.parametrize("lam,lr", LAM_LR_GRID)
def test_adam_representations_full(lam, lr):
    # DENSE_UPDATE_DENSE_VARIANCE ("full_adam"): dense m and v with the L2
    # term folded into both moments; no decay fold on the parameter update.
    beta1, beta2, eps = 0.9, 0.999, 1e-6
    params, grads = make_params(), make_grads()
    opt = Optimizer(
        cfg_for(UpdateMethod.ADAM, AdamMode.DENSE_UPDATE_DENSE_VARIANCE, lr, lam)
    )
    state = opt.init(params)
    new, new_state = opt.apply(params, state, grads, lr, lam)

    desc = grads.word[0]
    p = np.asarray(params.word_reprs)
    scattered = np_scatter((NUM_WORDS, D_W), desc)
    m = (1 - beta1) * scattered - (1 - beta1) * lam * p
    agg = scattered - lam * p
    v = (1 - beta2) * agg**2
    bc = np.sqrt(1 - beta2) / (1 - beta1)
    want = p + lr * bc * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(np.asarray(new.word_reprs), want, rtol=1e-10)


@pytest.mark.parametrize("rows,dim", [(1, 3), (37, 13), (301, 300)])
def test_full_adam_sweep_float32_vs_float64(rows, dim):
    """The shipped float32 full_adam sweep (scatter, L2 folded into the
    moments, bias-corrected dense step from non-zero m, v at t=3) against
    its float64 closed form, at odd row counts."""
    from cunvsm.optim.updates import ReprAdamState, _repr_adam_full

    rng = np.random.RandomState(rows)
    beta1, beta2, eps, lr, lam, t = 0.9, 0.999, 1e-6, 1e-3, 2e-4, 3
    table = (0.05 * rng.randn(rows, dim)).astype(np.float32)
    m = (1e-3 * rng.randn(rows, dim)).astype(np.float32)
    v = (1e-6 * np.abs(rng.randn(rows, dim))).astype(np.float32)
    idx = rng.randint(0, rows, (23, 3)).astype(np.int32)
    w = rng.rand(23, 3).astype(np.float32)
    g = (1e-2 * rng.randn(23, dim)).astype(np.float32)
    state = ReprAdamState(
        jnp.asarray(m), jnp.asarray(v), jnp.asarray(t, jnp.int32)
    )
    desc = SparseGrad(jnp.asarray(g), jnp.asarray(idx), jnp.asarray(w))
    state, new = _repr_adam_full(
        state, jnp.asarray(table), (desc,), lr, lam, beta1, beta2, eps
    )
    assert new.dtype == jnp.float32 and state.m.dtype == jnp.float32

    s = np.zeros((rows, dim))
    upd = w[:, :, None].astype(np.float64) * g[:, None, :]
    np.add.at(s, idx.reshape(-1), upd.reshape(-1, dim))
    p = table.astype(np.float64)
    agg = s - lam * p
    m_want = beta1 * m + (1 - beta1) * agg
    v_want = beta2 * v + (1 - beta2) * agg**2
    bc = np.sqrt(1 - beta2**t) / (1 - beta1**t)
    p_want = p + lr * bc * m_want / (np.sqrt(v_want) + eps)
    np.testing.assert_allclose(
        np.asarray(state.m), m_want, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(state.v), v_want, rtol=1e-5, atol=1e-13)
    # f32 rounding, amplified by m / (sqrt(v) + eps) where v is near eps^2.
    np.testing.assert_allclose(np.asarray(new), p_want, rtol=0, atol=1e-5)
    assert int(state.t) == t + 1


def test_full_adam_multiple_descriptors():
    """Composite objectives produce several descriptors for one table;
    full_adam must accumulate all of them (CompositeGradients path,
    intermediate_results.cu:320-342)."""
    params = make_params()
    g1 = make_grads(seed=1)
    g2 = make_grads(seed=2)
    grads = AscentGrads(
        word=(g1.word[0], g2.word[0]),
        entity=(g1.entity[0],),
        transform_w=g1.transform_w,
        transform_b=g1.transform_b,
    )
    lam, lr = 0.1, 0.5
    opt = Optimizer(
        cfg_for(UpdateMethod.ADAM, AdamMode.DENSE_UPDATE_DENSE_VARIANCE, lr, lam)
    )
    state = opt.init(params)
    new, _ = opt.apply(params, state, grads, lr, lam)

    beta1, beta2, eps = 0.9, 0.999, 1e-6
    p = np.asarray(params.word_reprs)
    scattered = np_scatter((NUM_WORDS, D_W), g1.word[0]) + np_scatter(
        (NUM_WORDS, D_W), g2.word[0]
    )
    m = (1 - beta1) * scattered - (1 - beta1) * lam * p
    agg = scattered - lam * p
    v = (1 - beta2) * agg**2
    bc = np.sqrt(1 - beta2) / (1 - beta1)
    want = p + lr * bc * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(np.asarray(new.word_reprs), want, rtol=1e-10)


def test_sparse_modes_reject_multiple_descriptors():
    # Parity with CHECK_EQ(gradient_descs->size(), 1)
    # (updates_adagrad.cu:108, updates_adam.cu:348).
    params = make_params()
    g = make_grads()
    multi = AscentGrads(
        word=(g.word[0], g.word[0]),
        entity=(),
        transform_w=None,
        transform_b=None,
    )
    for method, mode in [
        (UpdateMethod.ADAGRAD, None),
        (UpdateMethod.ADAM, AdamMode.SPARSE),
    ]:
        opt = Optimizer(cfg_for(method, mode))
        state = opt.init(params)
        with pytest.raises(AssertionError):
            opt.apply(params, state, multi, 0.5, 0.0)


class TestSegmentAccumulateLayouts:
    """The sort layouts in _sorted_segment_accumulate (packed uint32 /
    two-operand / three-operand) must all reproduce the reference scatter
    semantics exactly, including at the 16-bit packing boundaries."""

    def _check(self, num_rows, desc, monkeypatch=None, variant=None):
        from cunvsm.optim.updates import _sorted_segment_accumulate

        if variant is not None:
            monkeypatch.setenv("CUNVSM_ACCUM_VARIANT", variant)
        got = np.asarray(_sorted_segment_accumulate(num_rows, (desc,)))
        want = np_scatter((num_rows, desc.grad.shape[1]), desc)
        np.testing.assert_allclose(got, want, rtol=1e-10)

    def test_packed_boundary_ids(self):
        # Row ids at the top of the 16-bit range (>= 2^15 would flip the
        # sign bit of an int32 key; the packed key is uint32).
        num_rows = 1 << 16
        rng = np.random.RandomState(0)
        n_inst, window, dim = 7, 3, 2
        idx = rng.randint(0, num_rows, (n_inst, window)).astype(np.int32)
        idx[0, 0] = num_rows - 1
        idx[1, :] = num_rows - 1  # duplicates of the max id
        idx[2, 0] = 0
        desc = SparseGrad(
            grad=jnp.asarray(rng.randn(n_inst, dim)),
            indices=jnp.asarray(idx),
            weights=None,
        )
        self._check(num_rows, desc)

    def test_weightfree_above_packing_bound(self):
        # num_rows > 2^16 forces the two-operand weight-free layout.
        num_rows = (1 << 16) + 8
        rng = np.random.RandomState(1)
        n_inst, window, dim = 5, 2, 3
        idx = rng.randint(0, num_rows, (n_inst, window)).astype(np.int32)
        idx[0, 0] = num_rows - 1
        desc = SparseGrad(
            grad=jnp.asarray(rng.randn(n_inst, dim)),
            indices=jnp.asarray(idx),
            weights=None,
        )
        self._check(num_rows, desc)

    def test_twoop_weighted_variant(self, monkeypatch):
        rng = np.random.RandomState(2)
        n_inst, window, dim, num_rows = 6, 4, 3, 11
        desc = SparseGrad(
            grad=jnp.asarray(rng.randn(n_inst, dim)),
            indices=jnp.asarray(
                rng.randint(0, num_rows, (n_inst, window)), jnp.int32
            ),
            weights=jnp.asarray(rng.rand(n_inst, window) + 0.5),
        )
        self._check(num_rows, desc, monkeypatch, "twoop")


def test_uniform_feature_weights_flag_matches_explicit_ones():
    """TrainConfig.uniform_feature_weights must produce the same updates as
    explicit all-ones feature weights (it only changes the compute layout,
    never the math).  The weight-free layout takes the prefix-diff word
    accumulation (ops/prefix_diff.py), whose summation *order* differs from
    the scatter path, so equality is to accumulation rounding, not bits;
    with the path disabled the results must be bit-identical."""
    from cunvsm.config import ModelDesc, Nonlinearity
    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import init_params
    from cunvsm.train.step import make_train_step

    desc = ModelDesc(
        word_repr_size=5,
        entity_repr_size=4,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    base = TrainConfig(
        batch_size=8,
        window_size=3,
        num_random_entities=2,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=0.5,
        regularization_lambda=0.1,
    )
    rng = np.random.RandomState(3)
    batch = TextEntityBatch(
        features=jnp.asarray(rng.randint(0, 9, (8, 3)), jnp.int32),
        feature_weights=jnp.ones((8, 3)),
        labels=jnp.asarray(rng.randint(0, 6, (8,)), jnp.int32),
        weights=jnp.asarray(rng.rand(8) + 0.5),
    )
    key = jax.random.PRNGKey(7)

    def run(uniform):
        import dataclasses

        cfg = dataclasses.replace(base, uniform_feature_weights=uniform)
        params = init_params(jax.random.PRNGKey(0), 9, 6, desc)
        opt = Optimizer(cfg)
        step = make_train_step(desc, cfg, jit=False)
        p, _, cost = step(params, opt.init(params), batch, key)
        return (np.asarray(p.word_reprs), np.asarray(p.entity_reprs),
                float(cost))

    import os

    explicit = run(False)
    uniform_scatter = run(True)
    np.testing.assert_array_equal(explicit[0], uniform_scatter[0])
    np.testing.assert_array_equal(explicit[1], uniform_scatter[1])
    assert explicit[2] == uniform_scatter[2]

    os.environ["CUNVSM_PREFIX_DIFF"] = "1"
    try:
        uniform_prefix = run(True)
    finally:
        del os.environ["CUNVSM_PREFIX_DIFF"]
    np.testing.assert_allclose(
        explicit[0], uniform_prefix[0], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(explicit[1], uniform_prefix[1])
