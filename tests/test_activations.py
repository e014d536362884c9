"""Unit tests for the exact-semantics elementwise ops.

Modeled on the reference's cuda_utils_tests.cu (truncated sigmoid values
including saturation) plus explicit checks of the deliberate forward/backward
asymmetries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cunvsm.ops.activations import (
    hard_tanh,
    l2_normalize_rows,
    log_truncated_sigmoid,
    stable_sigmoid,
    truncated_sigmoid,
)


class TestTruncatedSigmoid:
    def test_values(self):
        x = jnp.array([0.0, 1.0, -1.0], dtype=jnp.float64)
        p = truncated_sigmoid(x, 1e-7)
        np.testing.assert_allclose(
            np.asarray(p),
            [0.5, 1.0 / (1.0 + np.exp(-1.0)), 1.0 / (1.0 + np.exp(1.0))],
            rtol=1e-12,
        )

    def test_saturation_clips(self):
        # cuda_utils_tests.cu:8-21 checks saturation at the epsilon bounds.
        x = jnp.array([-100.0, 100.0], dtype=jnp.float64)
        p = truncated_sigmoid(x, 1e-7)
        np.testing.assert_allclose(np.asarray(p), [1e-7, 1.0 - 1e-7])

    def test_stable_at_extremes(self):
        x = jnp.array([-1e4, 1e4], dtype=jnp.float64)
        p = stable_sigmoid(x)
        assert np.all(np.isfinite(np.asarray(p)))


class TestLogTruncatedSigmoid:
    def test_forward_matches_log_of_trunc(self):
        x = jnp.linspace(-30.0, 30.0, 101, dtype=jnp.float64)
        got = log_truncated_sigmoid(x, 1e-7, 1e-6)
        want = jnp.log(truncated_sigmoid(x, 1e-7))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want))

    def test_gradient_is_one_minus_p_inside(self):
        x = jnp.array([0.0, 2.0, -2.0], dtype=jnp.float64)
        g = jax.grad(lambda v: jnp.sum(log_truncated_sigmoid(v, 1e-7, 1e-6)))(x)
        p = truncated_sigmoid(x, 1e-7)
        np.testing.assert_allclose(np.asarray(g), np.asarray(1.0 - p))

    def test_gradient_zero_when_clipped(self):
        # Backward epsilon is 1e-6 (looser than the forward 1e-7):
        # cuda_utils.h:216-235 / objective.cu:368.
        x = jnp.array([-50.0, 50.0], dtype=jnp.float64)
        g = jax.grad(lambda v: jnp.sum(log_truncated_sigmoid(v, 1e-7, 1e-6)))(x)
        np.testing.assert_array_equal(np.asarray(g), [0.0, 0.0])

    def test_backward_eps_looser_than_forward(self):
        # p in (1e-7, 1e-6] -> forward unclipped but gradient still zeroed.
        x = jnp.array([np.log(5e-7 / (1 - 5e-7))], dtype=jnp.float64)
        p = truncated_sigmoid(x, 1e-7)
        assert 1e-7 < float(p[0]) < 1e-6
        g = jax.grad(lambda v: jnp.sum(log_truncated_sigmoid(v, 1e-7, 1e-6)))(x)
        assert float(g[0]) == 0.0

    def test_eps_zero_mode(self):
        x = jnp.array([0.0], dtype=jnp.float64)
        g = jax.grad(lambda v: jnp.sum(log_truncated_sigmoid(v, 0.0, 0.0)))(x)
        np.testing.assert_allclose(np.asarray(g), [0.5])


class TestHardTanh:
    def test_forward(self):
        x = jnp.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], dtype=jnp.float64)
        np.testing.assert_allclose(
            np.asarray(hard_tanh(x)),
            [-1.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.0],
        )

    def test_gradient_mask(self):
        # Derivative is 1 iff the input is in [-1, 1] inclusive
        # (cuda_utils.h:119-147 widened-bounds output test is equivalent).
        x = jnp.array([-2.0, -1.0, 0.0, 1.0, 2.0], dtype=jnp.float64)
        g = jax.grad(lambda v: jnp.sum(hard_tanh(v)))(x)
        np.testing.assert_array_equal(np.asarray(g), [0.0, 1.0, 1.0, 1.0, 0.0])


class TestL2Normalize:
    def test_rows_unit_norm(self, rng):
        x = jnp.asarray(rng.randn(5, 7))
        y = l2_normalize_rows(x)
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(y), axis=1), np.ones(5), rtol=1e-12
        )

    def test_gradient_matches_quotient_rule(self, rng):
        # Normalizer::backward (cuda_utils.cu:48-141) implements the full
        # quotient rule; autodiff must agree with a manual computation.
        x = jnp.asarray(rng.randn(3, 4))
        v = jnp.asarray(rng.randn(3, 4))

        def f(x_):
            return jnp.sum(l2_normalize_rows(x_) * v)

        g = jax.grad(f)(x)
        norms = jnp.linalg.norm(x, axis=1, keepdims=True)
        manual = v / norms - x * jnp.sum(x * v, axis=1, keepdims=True) / norms**3
        np.testing.assert_allclose(np.asarray(g), np.asarray(manual), rtol=1e-10)
