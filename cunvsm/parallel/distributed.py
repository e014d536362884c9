"""Multi-process (multi-host) runtime glue.

The reference is a single-GPU binary (SURVEY.md §2.4 — no distributed
layer at all); this framework's scaling story is a ``jax.sharding.Mesh``
over the global device set.  A multi-host run is N identical processes
(one per host, each driving all of its host's cards):
``jax.distributed.initialize`` wires them into ONE global device set, and
every jit / shard_map in the framework then spans hosts transparently —
the mesh paths (parallel/mesh.py, data/device_sampler.py) were built on
global-array semantics, so the SAME training code runs single- or
multi-process:

* ``jax.device_put(host_array, NamedSharding(...))`` places each
  process's addressable shards from its local host copy (every prepare_*
  function already feeds global shardings this way);
* jitted programs take host inputs (PRNG keys, cursors) replicated and
  return fully-replicated scalars every process can ``float()``;
* cross-process collectives are inserted by GSPMD exactly like
  cross-chip ones (on CPU test meshes they run over gloo).

What genuinely differs in a multi-process run is concentrated here and in
``io/checkpoint.py``:

* **initialization** — ``initialize()`` below, called before any backend
  use (``cunvsm-train --coordinator_address/--num_processes/--process_id``,
  or bare ``--distributed`` for clusters jax auto-detects, e.g. SLURM);
* **host materialization** — a global array spanning processes is not
  fully addressable, so ``np.asarray`` is illegal; ``fetch`` runs the
  collective ``process_allgather`` (every process must call it — it is a
  collective, with the same matched-control-flow contract as any psum);
* **checkpoint IO** — snapshots of non-addressable arrays must be fetched
  collectively on the training thread, and exactly one process may write
  (io/checkpoint.AsyncCheckpointWriter gates on ``is_primary``).

Verified end to end by tests/test_distributed.py: two OS processes x 4
virtual CPU devices each (gloo collectives) train the flagship sharded
on-device-sampling program and the data-axis-sharded corpus program on a
2x4 mesh; final tables match the identical single-process 8-device run to
collective summation-order rounding (~1 ulp).
"""

from __future__ import annotations

from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join (or form) the multi-process runtime.

    Must run before the first backend use in the process.  With no
    arguments, defers entirely to jax's cluster auto-detection (well-known
    cluster environments); explicit arguments are for manual launches (one
    process per host, all three flags set, the coordinator address
    reachable from every host).

    One process drives all the cards of its host: a JAX process reserves
    most of the memory of every card it can see, so two processes on one
    GPU host would fight over each card.  There is no one-process-per-card
    launch; a single host with several cards needs no ``initialize`` at all.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def process_count() -> int:
    import jax

    return jax.process_count()


def is_primary() -> bool:
    """True on the one process that owns file writes (checkpoints, meta,
    sidecars).  Always true single-process."""
    import jax

    return jax.process_index() == 0


def fetch(tree):
    """Host-materialize a tree of (possibly global) arrays on EVERY process.

    Fully-addressable leaves (single-process arrays, host numpy) pass
    through ``np.asarray``; leaves spanning processes are gathered with the
    collective ``process_allgather`` — so under multi-process, every
    process must call ``fetch`` at the same point (matched control flow),
    exactly like any other collective.
    """
    import jax
    import numpy as np

    def one(leaf):
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
            from jax.experimental import multihost_utils

            return multihost_utils.process_allgather(leaf, tiled=True)
        return np.asarray(leaf)

    return jax.tree_util.tree_map(one, tree)
