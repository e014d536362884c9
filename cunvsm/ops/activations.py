"""Elementwise math matching the reference's numeric semantics exactly.

The reference implements these as thrust functors (cuda_utils.h:58-237).
All of these fuse into surrounding XLA computations; the only thing
that needs care is replicating the *deliberate* forward/backward asymmetries:

* ``truncated_sigmoid``: a numerically-stable sigmoid clipped into
  ``[eps, 1-eps]`` (cuda_utils.h:192-214).
* ``log_truncated_sigmoid``: the reference backward pass uses
  ``d log(sigma)/dx = (1 - p)`` but zeroes the gradient whenever ``p`` is at
  (or beyond) a *different* epsilon than the forward clip
  (``sigmoid_to_log_sigmoid_deriv``, cuda_utils.h:216-235: backward eps 1e-6
  vs forward eps 1e-7 at the call sites objective.cu:246,368).  We implement
  it as a custom-VJP primitive so jax.grad reproduces the CUDA gradients
  bit-for-bit in float64.
* ``hard_tanh``: clip to [-1, 1] with derivative 1 exactly when the *input*
  lies in [-1, 1] (the reference tests the output against nextafter-widened
  bounds, cuda_utils.h:85-147, which is equivalent to an inclusive test on
  the input).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def stable_sigmoid(x: jax.Array) -> jax.Array:
    """Numerically-stable sigmoid (cuda_utils.h:201-207)."""
    return jnp.where(
        x >= 0,
        1.0 / (1.0 + jnp.exp(-jnp.abs(x))),
        jnp.exp(-jnp.abs(x)) / (1.0 + jnp.exp(-jnp.abs(x))),
    )


def truncated_sigmoid(x: jax.Array, eps: float) -> jax.Array:
    """sigmoid clipped into [eps, 1-eps] (cuda_utils.h:192-214)."""
    p = stable_sigmoid(x)
    return jnp.clip(p, eps, 1.0 - eps)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def log_truncated_sigmoid(x: jax.Array, eps_forward: float, eps_backward: float):
    """log(truncated_sigmoid(x)) with the reference's surrogate gradient.

    Forward: log(clip(sigmoid(x), eps_forward, 1-eps_forward))
             (objective.cu:241-256).
    Backward: g * (1 - p) masked to zero when p <= eps_backward or
              p >= 1-eps_backward (objective.cu:354-371; cuda_utils.h:216-235).
    """
    return jnp.log(truncated_sigmoid(x, eps_forward))


def _log_trunc_sig_fwd(x, eps_forward, eps_backward):
    p = truncated_sigmoid(x, eps_forward)
    return jnp.log(p), p


def _log_trunc_sig_bwd(eps_forward, eps_backward, p, g):
    inside = jnp.logical_and(p > eps_backward, p < 1.0 - eps_backward)
    return (g * jnp.where(inside, 1.0 - p, 0.0),)


log_truncated_sigmoid.defvjp(_log_trunc_sig_fwd, _log_trunc_sig_bwd)


@jax.custom_vjp
def hard_tanh(x: jax.Array) -> jax.Array:
    """clip(x, -1, 1); derivative is 1 iff x in [-1, 1] (cuda_utils.h:85-147)."""
    return jnp.clip(x, -1.0, 1.0)


def _hard_tanh_fwd(x):
    return jnp.clip(x, -1.0, 1.0), x


def _hard_tanh_bwd(x, g):
    inside = jnp.logical_and(x >= -1.0, x <= 1.0)
    return (jnp.where(inside, g, 0.0),)


hard_tanh.defvjp(_hard_tanh_fwd, _hard_tanh_bwd)


def l2_normalize_rows(x: jax.Array) -> jax.Array:
    """Per-row L2 normalization (Normalizer, cuda_utils.cu:3-141).

    The reference normalizes per *column* of its column-major matrices, which
    corresponds to per-instance rows here.  Autodiff through this expression
    reproduces the reference's hand-written quotient-rule backward.

    All-zero rows (which the reference never produces, but zero-weight
    padding instances do) normalize to zero instead of NaN; the clamp is
    inactive for any row of realistic magnitude.
    """
    norms = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.maximum(norms, jnp.asarray(1e-30, x.dtype))
