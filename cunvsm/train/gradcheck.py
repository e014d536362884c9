"""Finite-difference gradient checking (GradientCheckFn, gradient_check.cu).

The reference's deepest correctness oracle: central finite differences over
*every* scalar parameter, compared against the analytic gradients, in a
float64 build.  Here the analytic gradients come from the same
``compute_cost_and_grads`` used in training (with a fixed PRNG key replaying
the negative samples, mirroring the RNG-state snapshot in model.cu:154-174),
densified through the sparse descriptors' scatter semantics.

Run on the CPU backend with jax_enable_x64 for float64 fidelity.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cunvsm.config import ModelDesc, TrainConfig
from cunvsm.models.objectives import AscentGrads
from cunvsm.models.params import ModelParams
from cunvsm.optim.updates import _scatter_updates
from cunvsm.train.step import (
    ObjectiveKind,
    compute_cost_and_grads,
    make_optimized_cost_fn,
)


def densify_grads(params: ModelParams, grads: AscentGrads) -> ModelParams:
    """Scatter sparse descriptors into dense per-table ascent gradients."""

    def dense(table, descs):
        out = jnp.zeros_like(table)
        for desc in descs:
            idx, upd = _scatter_updates(desc)
            out = out.at[idx].add(upd)
        return out

    return ModelParams(
        word_reprs=dense(params.word_reprs, grads.word),
        entity_reprs=dense(params.entity_reprs, grads.entity),
        transform_w=(
            grads.transform_w
            if grads.transform_w is not None
            else jnp.zeros_like(params.transform_w)
        ),
        transform_b=(
            grads.transform_b
            if grads.transform_b is not None
            else jnp.zeros_like(params.transform_b)
        ),
    )


def check_gradients(
    kind: ObjectiveKind,
    params: ModelParams,
    batch,
    key: jax.Array,
    desc: ModelDesc,
    cfg: TrainConfig,
    epsilon: float = 1e-6,
    rtol: float = 1e-4,
    atol: float = 1e-8,
) -> Tuple[int, float]:
    """Central-difference check of every parameter.

    Returns (num_checked, max_relative_error); raises AssertionError on
    disagreement.  Note the analytic gradients are *ascent* gradients while
    the cost function is the descent objective, so the expected relation is
    analytic = -(dcost/dtheta).
    """
    cost_fn = make_optimized_cost_fn(desc, cfg, kind)
    _, grads = compute_cost_and_grads(kind, params, batch, key, desc, cfg)
    dense = densify_grads(params, grads)

    flat_params, treedef = jax.tree_util.tree_flatten(params)
    flat_dense = treedef.flatten_up_to(dense)

    num_checked = 0
    max_rel_err = 0.0
    for leaf_idx, (p_leaf, g_leaf) in enumerate(zip(flat_params, flat_dense)):
        n = p_leaf.size
        basis = jnp.eye(n, dtype=p_leaf.dtype).reshape((n,) + p_leaf.shape)

        def cost_with_delta(delta):
            leaves = list(flat_params)
            leaves[leaf_idx] = p_leaf + delta
            return cost_fn(
                jax.tree_util.tree_unflatten(treedef, leaves), batch, key
            )

        # All perturbations of this leaf in two batched evaluations.
        cost_plus = jax.vmap(cost_with_delta)(epsilon * basis)
        cost_minus = jax.vmap(cost_with_delta)(-epsilon * basis)
        numeric_descent = np.asarray(
            (cost_plus - cost_minus) / (2.0 * epsilon), dtype=np.float64
        )
        expected = -numeric_descent  # ascent convention
        analytic = np.asarray(g_leaf, dtype=np.float64).reshape(-1)

        denom = np.maximum(
            np.maximum(np.abs(expected), np.abs(analytic)), 1e-12
        )
        rel_err = np.abs(expected - analytic) / denom
        ok = (np.abs(expected - analytic) <= atol) | (rel_err <= rtol)
        if not np.all(ok):
            i = int(np.argmax(np.where(ok, -np.inf, rel_err)))
            raise AssertionError(
                f"gradient mismatch at leaf {leaf_idx} flat idx {i}: "
                f"finite-diff(ascent)={expected[i]:.10g} "
                f"analytic={analytic[i]:.10g} rel_err={rel_err[i]:.3g}"
            )
        max_rel_err = max(max_rel_err, float(rel_err.max()))
        num_checked += n

    return num_checked, max_rel_err
