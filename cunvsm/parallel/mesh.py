"""Multi-chip sharding: the layer the reference never had (SURVEY.md §2.4).

Design (pick a mesh, annotate shardings, let XLA/GSPMD insert the
collectives, which run over NVLink within a host):

* a 2D ``Mesh`` with axes ``("data", "model")`` — data parallelism over the
  batch axis; the **entity (document) table is the only tensor that
  outgrows one card** (|D| x d_e at collection scale), so it and its
  optimizer moments shard row-wise over the ``model`` axis.  The cards of
  a host reach each other all to all at one rate, so the mesh shape
  follows the algorithm alone;
* the word table and transform are small (65k x 300 ~ 78 MB fp32) and stay
  replicated;
* the train step itself is the *same* pure function as single-chip
  (train/step.py); GSPMD partitions the gathers, the scatter-adds, and the
  loss reduction, inserting all-gathers/psums automatically.  No PP/EP/CP:
  this model family has no layer pipeline or experts to justify them
  (SURVEY.md §2.4).

Query-side sharding (the doc-score matmul + top-k merge) lives in
``parallel/query.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cunvsm.config import ModelDesc, TrainConfig
from cunvsm.models import objectives as obj
from cunvsm.models.params import ModelParams
from cunvsm.optim.updates import Optimizer, OptState
from cunvsm.train.step import ObjectiveKind, make_train_step

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    data: int, model: int, devices: Optional[np.ndarray] = None
) -> Mesh:
    if devices is None:
        devs = np.asarray(jax.devices()[: data * model])
    else:
        devs = np.asarray(devices)
    assert devs.size == data * model, (
        f"need {data * model} devices, have {devs.size}"
    )
    return Mesh(devs.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split devices between data and model axes: prefer model-sharding the
    entity table with data parallelism on top."""
    if n_devices <= 1:
        return (1, 1)
    if n_devices % 2:
        return (1, n_devices)
    return (2, n_devices // 2)


def _entity_sharded(mesh: Mesh):
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def _entity_vector_sharded(mesh: Mesh):
    return NamedSharding(mesh, P(MODEL_AXIS))


def _replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def _batch_sharded(mesh: Mesh, ndim: int):
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def param_shardings(mesh: Mesh, params: ModelParams) -> ModelParams:
    return ModelParams(
        word_reprs=_replicated(mesh),
        entity_reprs=_entity_sharded(mesh),
        transform_w=_replicated(mesh),
        transform_b=_replicated(mesh),
    )


def opt_state_shardings(
    mesh: Mesh, opt_state: OptState, num_entities: int
) -> OptState:
    """Shard every optimizer slot whose leading dim is the entity count
    (m, v, adagrad accumulators) the same way as the entity table."""

    def leaf_sharding(leaf):
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == num_entities:
            if leaf.ndim == 1:
                return _entity_vector_sharded(mesh)
            return _entity_sharded(mesh)
        return _replicated(mesh)

    word = jax.tree_util.tree_map(lambda _: _replicated(mesh), opt_state.word)
    entity = jax.tree_util.tree_map(leaf_sharding, opt_state.entity)
    transform = jax.tree_util.tree_map(
        lambda _: _replicated(mesh), opt_state.transform
    )
    return OptState(word=word, entity=entity, transform=transform)


def batch_shardings(mesh: Mesh, batch, stacked: bool = False):
    """Shard the batch axis over the data axis; with ``stacked`` the leading
    [K, ...] step axis is replicated and the second axis is the batch."""
    if isinstance(batch, tuple) and not hasattr(batch, "_fields"):
        return tuple(batch_shardings(mesh, b, stacked) for b in batch)

    def leaf_sharding(leaf):
        if leaf is None:  # optional fields (e.g. TextEntityBatch.negatives)
            return None
        if stacked:
            spec = P(None, DATA_AXIS, *([None] * (leaf.ndim - 2)))
        else:
            spec = P(DATA_AXIS, *([None] * (leaf.ndim - 1)))
        return NamedSharding(mesh, spec)

    return type(batch)(*[leaf_sharding(leaf) for leaf in batch])


def shard_tree(tree, shardings):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), tree, shardings
    )


def pad_entities(n: int, model_axis: int) -> int:
    """Entity-table rows padded up to a multiple of the model axis."""
    return ((n + model_axis - 1) // model_axis) * model_axis


def make_sharded_train_step(
    desc: ModelDesc,
    cfg: TrainConfig,
    mesh: Mesh,
    params: ModelParams,
    opt_state: OptState,
    example_batch,
    kind: Optional[ObjectiveKind] = None,
    num_entities: Optional[int] = None,
):
    """jit the train step with explicit in/out shardings over the mesh.

    Returns (step_fn, sharded_params, sharded_opt_state).  The caller feeds
    host batches; jit moves them to the mesh according to the batch
    shardings.
    """
    p_sh = param_shardings(mesh, params)
    o_sh = opt_state_shardings(mesh, opt_state, params.num_entities)
    b_sh = batch_shardings(mesh, example_batch)

    step = make_train_step(
        desc, cfg, kind, jit=False, num_entities=num_entities, mesh=mesh,
    )
    sharded = jax.jit(
        step,
        in_shardings=(p_sh, o_sh, b_sh, _replicated(mesh)),
        out_shardings=(p_sh, o_sh, _replicated(mesh)),
        donate_argnums=(0, 1),
    )
    return (
        sharded,
        shard_tree(params, p_sh),
        shard_tree(opt_state, o_sh),
    )


def make_sharded_multistep(
    desc: ModelDesc,
    cfg: TrainConfig,
    mesh: Mesh,
    params: ModelParams,
    opt_state: OptState,
    example_batch,
    num_steps: int,
    kind: Optional[ObjectiveKind] = None,
    num_entities: Optional[int] = None,
):
    """K chained sharded steps per compiled call: stacked [K, ...] batches
    (batch axis sharded over data), one key, lax.scan inside the pjit."""
    p_sh = param_shardings(mesh, params)
    o_sh = opt_state_shardings(mesh, opt_state, params.num_entities)
    b_sh = batch_shardings(mesh, example_batch, stacked=True)

    step = make_train_step(
        desc, cfg, kind, jit=False, num_entities=num_entities, mesh=mesh,
    )

    def multistep(params, opt_state, stacked_batches, key):
        keys = jax.random.split(key, num_steps)

        def body(carry, inputs):
            p, o = carry
            batch, k = inputs
            p, o, cost = step(p, o, batch, k)
            return (p, o), cost

        (params, opt_state), costs = jax.lax.scan(
            body, (params, opt_state), (stacked_batches, keys)
        )
        return params, opt_state, costs

    sharded = jax.jit(
        multistep,
        in_shardings=(p_sh, o_sh, b_sh, _replicated(mesh)),
        out_shardings=(p_sh, o_sh, _replicated(mesh)),
        donate_argnums=(0, 1),
    )
    return (
        sharded,
        shard_tree(params, p_sh),
        shard_tree(opt_state, o_sh),
    )
