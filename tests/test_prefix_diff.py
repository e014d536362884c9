"""Differential tests for the scatter-free prefix-diff accumulation.

The Python scatter loop is the semantic oracle (update_repr_kernel,
/root/reference/cpp/storage.cu:37-49: duplicate indices accumulate); the
prefix-diff path must match it and the XLA sorted-scatter path bit-for-bit
at float64 and to accumulation tolerance at float32/bfloat16.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.models.objectives import SparseGrad
from cunvsm.ops.prefix_diff import (
    prefix_diff_applicable,
    prefix_diff_segment_sum,
)
from cunvsm.optim.updates import _sorted_segment_accumulate


@pytest.fixture(autouse=True)
def _enable_prefix_diff(monkeypatch):
    # The path is opt-in; tests force it on.
    monkeypatch.setenv("CUNVSM_PREFIX_DIFF", "1")


def _reference(grad, indices, num_rows):
    out = np.zeros((num_rows, grad.shape[1]), dtype=np.float64)
    for i in range(indices.shape[0]):
        for w in range(indices.shape[1]):
            out[indices[i, w]] += grad[i]
    return out


@pytest.mark.parametrize(
    "n_inst,window,num_rows,dim,chunk",
    [
        (7, 3, 5, 4, 4),       # padding needed, multiple chunks
        (16, 2, 8, 3, 8),      # exact chunk fit (32 + 8 = 5 chunks)
        (12, 4, 64, 6, 16),    # many empty rows
        (30, 5, 2, 3, 8),      # long segments (all mass on 2 rows)
        (50, 4, 40, 5, 128),   # single chunk (m < chunk)
        (9, 1, 9, 2, 4),       # window 1
    ],
)
def test_matches_scatter_oracle(rng, n_inst, window, num_rows, dim, chunk):
    grad = rng.randn(n_inst, dim)
    indices = rng.randint(0, num_rows, (n_inst, window))
    out = prefix_diff_segment_sum(
        jnp.asarray(grad), jnp.asarray(indices, jnp.int32), num_rows,
        chunk=chunk,
    )
    np.testing.assert_allclose(
        np.asarray(out), _reference(grad, indices, num_rows),
        rtol=1e-12, atol=1e-12,
    )


def test_all_updates_one_row(rng):
    grad = rng.randn(11, 3)
    indices = np.full((11, 2), 4)
    out = prefix_diff_segment_sum(
        jnp.asarray(grad), jnp.asarray(indices, jnp.int32), 6, chunk=4
    )
    np.testing.assert_allclose(
        np.asarray(out), _reference(grad, indices, 6), rtol=1e-12, atol=1e-12
    )


def test_bfloat16_stream(rng):
    grad = rng.randn(40, 8).astype(np.float32)
    indices = rng.randint(0, 16, (40, 3))
    out = prefix_diff_segment_sum(
        jnp.asarray(grad), jnp.asarray(indices, jnp.int32), 16,
        stream_dtype="bfloat16", chunk=8,
    )
    assert out.dtype == jnp.float32
    ref = _reference(
        np.asarray(jnp.asarray(grad).astype(jnp.bfloat16).astype(jnp.float32)),
        indices, 16,
    )
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)


def test_applicability_gate():
    assert prefix_diff_applicable(100, 10, 64, None, None)
    # weighted descriptors keep the sorted-scatter path
    assert not prefix_diff_applicable(100, 10, 64, jnp.ones((100, 10)), None)
    # bfloat16 partial-sum accumulation is a scatter-path-only option
    assert not prefix_diff_applicable(100, 10, 64, None, "bfloat16")
    # instance ids must stay below the sentinel marker
    assert not prefix_diff_applicable(0xFFFF, 10, 64, None, None)
    # row ids must fit 16 bits
    assert not prefix_diff_applicable(100, 10, (1 << 16) + 1, None, None)
    # sentinel overhead must amortize
    assert not prefix_diff_applicable(4, 2, 64, None, None)
    os.environ["CUNVSM_PREFIX_DIFF"] = "0"
    try:
        assert not prefix_diff_applicable(100, 10, 64, None, None)
    finally:
        os.environ["CUNVSM_PREFIX_DIFF"] = "1"
    # Opt-in: without the env the gate stays closed.
    del os.environ["CUNVSM_PREFIX_DIFF"]
    try:
        assert not prefix_diff_applicable(100, 10, 64, None, None)
    finally:
        os.environ["CUNVSM_PREFIX_DIFF"] = "1"


def test_accumulate_dispatch_equivalence(rng):
    """_sorted_segment_accumulate output is identical with the prefix path
    on and off (the FD-oracle-checked scatter path is the reference)."""
    grad = jnp.asarray(rng.randn(60, 5))
    indices = jnp.asarray(rng.randint(0, 32, (60, 4)), jnp.int32)
    desc = SparseGrad(grad=grad, indices=indices, weights=None)
    assert prefix_diff_applicable(60, 4, 32, None, None)
    on = _sorted_segment_accumulate(32, (desc,))
    os.environ["CUNVSM_PREFIX_DIFF"] = "0"
    try:
        off = _sorted_segment_accumulate(32, (desc,))
    finally:
        del os.environ["CUNVSM_PREFIX_DIFF"]
    np.testing.assert_allclose(
        np.asarray(on), np.asarray(off), rtol=1e-12, atol=1e-12
    )


def test_gradcheck_full_adam_uniform_pool(rng):
    """FD-check gradients of the strided rolled-pool objective, and run a
    full training step whose word accumulation takes the prefix-diff path
    (uniform weights + full_adam, the shipped configuration)."""
    from cunvsm.config import (
        AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig,
        UpdateMethod,
    )
    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import ModelParams
    from cunvsm.train.gradcheck import check_gradients
    from cunvsm.train.step import (
        ObjectiveKind, compute_cost_and_grads, objective_kind_from_config,
    )

    desc = ModelDesc(
        word_repr_size=4, entity_repr_size=3,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=8, window_size=3, num_random_entities=3,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=0.1, regularization_lambda=0.01,
        negative_pool_size=4, negative_pool_stride=3,
        uniform_feature_weights=True,
    )
    # Gate passes at these shapes for the word table (vocab 6 <= 2^16,
    # 8 instances, 24 updates >= 6 rows).
    assert prefix_diff_applicable(8, 3, 6, None, None)
    # float64 parameters: FD at eps=1e-6 needs the wide dtype.
    params = ModelParams(
        word_reprs=jnp.asarray(rng.randn(6, 4)),
        entity_reprs=jnp.asarray(rng.randn(5, 3)),
        transform_w=jnp.asarray(rng.randn(4, 3)),
        transform_b=jnp.asarray(rng.randn(3)),
    )
    batch = TextEntityBatch(
        features=jnp.asarray(rng.randint(0, 6, (8, 3)), jnp.int32),
        feature_weights=jnp.ones((8, 3)),
        labels=jnp.asarray(rng.randint(0, 5, (8,)), jnp.int32),
        weights=jnp.ones((8,)),
    )
    kind = objective_kind_from_config(cfg)
    assert kind == ObjectiveKind.TEXT_ENTITY
    num_checked, max_rel_err = check_gradients(
        kind, params, batch, jax.random.PRNGKey(7), desc, cfg
    )
    assert num_checked > 0
    assert max_rel_err < 1e-4

    # One real optimizer step through the prefix-diff word accumulation,
    # compared against the same step with the path disabled.
    from cunvsm.optim.updates import Optimizer
    from cunvsm.train.step import make_train_step

    opt = Optimizer(cfg)
    step = make_train_step(desc, cfg, jit=False)
    p_on, _, c_on = step(
        params, opt.init(params), batch, jax.random.PRNGKey(3)
    )
    os.environ["CUNVSM_PREFIX_DIFF"] = "0"
    try:
        p_off, _, c_off = step(
            params, opt.init(params), batch, jax.random.PRNGKey(3)
        )
    finally:
        del os.environ["CUNVSM_PREFIX_DIFF"]
    np.testing.assert_allclose(float(c_on), float(c_off), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(p_on.word_reprs), np.asarray(p_off.word_reprs),
        rtol=1e-10, atol=1e-12,
    )
