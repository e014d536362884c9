"""Batch-normalization unit tests (cudnn_utils_tests.cu parity).

The reference wraps cuDNN PER_ACTIVATION BN with gamma frozen at 1, the
transform bias playing beta, epsilon 1e-4, and training-mode statistics
only (cudnn_utils.cu:49-183).
"""

import jax
import jax.numpy as jnp
import numpy as np

from cunvsm.ops.batchnorm import batch_norm_train


def test_constant_input_yields_beta():
    # cudnn_utils_tests.cu:19-36: BN of a constant batch is all zeros, so
    # the output equals beta broadcast over the batch.
    x = jnp.full((64, 8), 3.25)
    beta = jnp.asarray(np.linspace(-1.0, 1.0, 8))
    out = batch_norm_train(x, beta, eps=1e-4)
    np.testing.assert_allclose(
        np.asarray(out), np.broadcast_to(np.asarray(beta), (64, 8)),
        rtol=1e-6, atol=1e-6,
    )


def test_normalizes_per_activation():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(4096, 16) * 5.0 + 2.0)
    beta = jnp.zeros((16,))
    out = np.asarray(batch_norm_train(x, beta, eps=1e-4))
    # Per-column zero mean, ~unit variance (biased variance + eps).
    np.testing.assert_allclose(out.mean(axis=0), 0.0, atol=1e-6)
    np.testing.assert_allclose(out.std(axis=0), 1.0, atol=1e-2)


def test_deterministic_on_large_input():
    # cudnn_utils_tests.cu:38+: identical inputs give bit-identical outputs.
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(100_000, 16))
    beta = jnp.asarray(rng.randn(16))
    f = jax.jit(lambda a: batch_norm_train(a, beta, eps=1e-4))
    a = np.asarray(f(x))
    b = np.asarray(f(x))
    np.testing.assert_array_equal(a, b)


def test_biased_variance_and_epsilon():
    # Two-point batch: biased variance = (d/2)^2 where d = x1 - x0;
    # output = +-d/2 / sqrt((d/2)^2 + eps) + beta.
    eps = 1e-4
    x = jnp.asarray([[0.0], [2.0]])
    beta = jnp.asarray([0.5])
    out = np.asarray(batch_norm_train(x, beta, eps=eps))
    expect = np.array([[-1.0], [1.0]]) / np.sqrt(1.0 + eps) + 0.5
    np.testing.assert_allclose(out, expect, rtol=1e-6)


def test_gradients_match_finite_differences():
    # Forward+backward pairing (cudnn_utils_tests.cu:115+), float64 FD.
    rng = np.random.RandomState(2)
    x0 = rng.randn(6, 3)
    beta0 = rng.randn(3)
    weights = jnp.asarray(rng.randn(6, 3))

    def loss(x, beta):
        out = batch_norm_train(x, beta, eps=1e-4)
        return jnp.sum(jnp.tanh(out) * weights)

    gx, gb = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x0), jnp.asarray(beta0)
    )
    eps = 1e-6
    for idx in [(0, 0), (3, 1), (5, 2)]:
        dx = np.zeros_like(x0)
        dx[idx] = eps
        fd = (
            float(loss(jnp.asarray(x0 + dx), jnp.asarray(beta0)))
            - float(loss(jnp.asarray(x0 - dx), jnp.asarray(beta0)))
        ) / (2 * eps)
        np.testing.assert_allclose(fd, float(gx[idx]), rtol=1e-5, atol=1e-8)
    for j in range(3):
        db = np.zeros_like(beta0)
        db[j] = eps
        fd = (
            float(loss(jnp.asarray(x0), jnp.asarray(beta0 + db)))
            - float(loss(jnp.asarray(x0), jnp.asarray(beta0 - db)))
        ) / (2 * eps)
        np.testing.assert_allclose(fd, float(gb[j]), rtol=1e-5, atol=1e-8)
