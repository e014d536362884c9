"""Model parameters as a jax pytree.

Replaces the reference's parameter-class forest (Representations / Transform /
RepresentationsStorage / TransformStorage, params.cu + storage.cu) with one
immutable NamedTuple that jit/grad/shard transparently.

Array layouts (chosen to match the HDF5 checkpoint contract directly —
hdf5.cu:33 writes (cols, rows) so numpy/h5py sees objects-by-dims):

* ``word_reprs``:   [num_words,    word_dim]
* ``entity_reprs``: [num_entities, entity_dim]
* ``transform_w``:  [word_dim,     entity_dim]  (projection is x @ W + b)
* ``transform_b``:  [entity_dim]
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cunvsm.config import ModelDesc


class ModelParams(NamedTuple):
    word_reprs: jax.Array
    entity_reprs: jax.Array
    transform_w: jax.Array
    transform_b: jax.Array

    @property
    def num_words(self) -> int:
        return self.word_reprs.shape[0]

    @property
    def num_entities(self) -> int:
        return self.entity_reprs.shape[0]

    @property
    def word_dim(self) -> int:
        return self.word_reprs.shape[1]

    @property
    def entity_dim(self) -> int:
        return self.entity_reprs.shape[1]


def glorot_uniform(key: jax.Array, rows: int, cols: int, dtype) -> jax.Array:
    """Glorot/Xavier uniform on [-sqrt(6/(rows+cols)), +sqrt(6/(rows+cols))].

    Same limits as the reference host-side init (cuda_utils.h:35-56); the
    random stream differs (threefry vs minstd_rand0), which only matters for
    bit-exact replay, not statistics.
    """
    limit = (6.0 / (rows + cols)) ** 0.5
    return jax.random.uniform(
        key, (rows, cols), dtype=dtype, minval=-limit, maxval=limit
    )


def reference_init_params(
    engine,
    num_words: int,
    num_entities: int,
    desc: ModelDesc,
    dtype=jnp.float32,
    pad_entities_to: int = 0,
) -> ModelParams:
    """Bit-exact twin of the reference's host Glorot init, drawn from the
    shared minstd_rand0 ``engine`` (data/stdrng.py).

    Draw order follows ModelBase::initialize (model.cu:37-43): words, then
    entities, then the transform; the bias is zero-filled and consumes no
    draws (params.cu:361-372).  Each matrix is filled in device_matrix
    column-major order (init_matrix_glorot's linear loop, cuda_utils.h:44-47)
    with limits sqrt(6 / (rows + cols)) of the DEVICE shape — (repr_size,
    num_objects) for representations (storage.cu:10) and (entity_dim,
    word_dim) for the transform (storage.cu:190) — which lands exactly on
    this repo's numpy orientations ([objects, dim] / [word_dim, entity_dim])
    as a plain reshape of the sequential draw stream.  Values are computed
    in float32 like the reference's FLOATING_POINT_TYPE=float release build,
    then cast to ``dtype``.

    ``pad_entities_to`` > num_entities appends zero rows (mesh padding);
    padded rows consume no reference draws.
    """
    import numpy as np

    from cunvsm.data.stdrng import glorot_uniform_f32

    d_w, d_e = desc.word_repr_size, desc.entity_repr_size
    words = np.asarray(
        glorot_uniform_f32(engine, d_w, num_words), np.float32
    ).reshape(num_words, d_w)
    entities = np.asarray(
        glorot_uniform_f32(engine, d_e, num_entities), np.float32
    ).reshape(num_entities, d_e)
    transform = np.asarray(
        glorot_uniform_f32(engine, d_e, d_w), np.float32
    ).reshape(d_w, d_e)
    if pad_entities_to > num_entities:
        entities = np.concatenate(
            [entities, np.zeros((pad_entities_to - num_entities, d_e),
                                np.float32)]
        )
    return ModelParams(
        word_reprs=jnp.asarray(words, dtype),
        entity_reprs=jnp.asarray(entities, dtype),
        transform_w=jnp.asarray(transform, dtype),
        transform_b=jnp.zeros((d_e,), dtype=dtype),
    )


def init_params(
    key: jax.Array,
    num_words: int,
    num_entities: int,
    desc: ModelDesc,
    dtype=jnp.float32,
) -> ModelParams:
    """Glorot-init representations and transform; zero bias (params.cu:361-372)."""
    k_words, k_entities, k_transform = jax.random.split(key, 3)
    return ModelParams(
        word_reprs=glorot_uniform(
            k_words, num_words, desc.word_repr_size, dtype
        ),
        entity_reprs=glorot_uniform(
            k_entities, num_entities, desc.entity_repr_size, dtype
        ),
        transform_w=glorot_uniform(
            k_transform, desc.word_repr_size, desc.entity_repr_size, dtype
        ),
        transform_b=jnp.zeros((desc.entity_repr_size,), dtype=dtype),
    )
