"""HDF5 checkpoints byte-compatible with the reference, plus real resume.

Write contract (hdf5.cu + model.cu:64-93 + storage.cu:115-121,243-250):

* ``<prefix>_<epoch>.hdf5`` with one dataset per tensor:
    - ``word_representations-representations``   [num_words, word_dim]
    - ``entity_representations-representations`` [num_entities, entity_dim]
    - ``word_entity_mapping-transform``          [word_dim, entity_dim]
    - ``word_entity_mapping-bias``               [1, entity_dim]
  (the reference writes (cols, rows) dims from its column-major matrices,
  hdf5.cu:33, which lands exactly on these numpy shapes);
* files are never overwritten (H5F_ACC_EXCL, lse_hdf5_inl.h:25);
* a one-time ``<prefix>_meta`` serialized lse.Metadata protobuf with
  term/object id mappings and term frequencies (main.cu:527-537,
  data_indri.cpp:534-555).

Extensions beyond the reference (which has write-only checkpoints and no
resume, SURVEY.md §5):

* ``<prefix>_vocab.txt`` / ``<prefix>_docnos.txt`` sidecars holding the term
  and docno strings (the reference leans on pyndri for those at query time);
* ``save_training_state``/``load_training_state`` checkpoint optimizer state
  and the data-epoch cursor for true resume.

``h5py`` and ``protobuf`` are imported inside the HDF5 and metadata
functions, so training without ``output_prefix`` and in-memory ranking need
neither.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cunvsm.models.params import ModelParams

WORD_REPRS = "word_representations-representations"
ENTITY_REPRS = "entity_representations-representations"
TRANSFORM = "word_entity_mapping-transform"
BIAS = "word_entity_mapping-bias"


def checkpoint_path(prefix: str, epoch) -> str:
    return f"{prefix}_{epoch}.hdf5"


def _table_chunks(arr: np.ndarray):
    """Chunked storage for the representation tables: fixed row-block
    chunks keep partial reads (a serving process mapping a slice of a
    collection-scale table) and streamed writes O(chunk) instead of
    O(table); rank<2 or small tensors stay contiguous."""
    if arr.ndim != 2 or arr.shape[0] < 8192:
        return None
    return (min(arr.shape[0], 2048), arr.shape[1])


def save_model_hdf5(
    params: ModelParams, prefix: str, epoch, overwrite: bool = False
) -> str:
    path = checkpoint_path(prefix, epoch)
    # H5F_ACC_EXCL semantics (lse_hdf5_inl.h:25): refuse to overwrite.
    # ``overwrite`` is used by resumed runs re-dumping an epoch whose HDF5
    # landed before the crash cut off the resume state.  The file is
    # written to a temp name and renamed so a crash mid-write (the async
    # writer stretches that window) can never leave a truncated .hdf5 at
    # the contract path.
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    import h5py

    tmp_path = path + ".tmp"
    with h5py.File(tmp_path, "w") as f:
        word = np.asarray(params.word_reprs, dtype=np.float32)
        entity = np.asarray(params.entity_reprs, dtype=np.float32)
        f.create_dataset(WORD_REPRS, data=word, chunks=_table_chunks(word))
        f.create_dataset(
            ENTITY_REPRS, data=entity, chunks=_table_chunks(entity)
        )
        f.create_dataset(
            TRANSFORM, data=np.asarray(params.transform_w, dtype=np.float32)
        )
        f.create_dataset(
            BIAS,
            data=np.asarray(params.transform_b, dtype=np.float32).reshape(1, -1),
        )
    os.replace(tmp_path, path)
    return path


def load_model_hdf5(prefix: str, epoch) -> ModelParams:
    import h5py
    import jax.numpy as jnp

    with h5py.File(checkpoint_path(prefix, epoch), "r") as f:
        return ModelParams(
            word_reprs=jnp.asarray(f[WORD_REPRS][()]),
            entity_reprs=jnp.asarray(f[ENTITY_REPRS][()]),
            transform_w=jnp.asarray(f[TRANSFORM][()]),
            transform_b=jnp.asarray(f[BIAS][()]).reshape(-1),
        )


def build_metadata(
    index_term_ids: Sequence[int],
    term_frequencies: Sequence[int],
    num_objects: int,
    total_terms: int,
    include_oov: bool,
    index_object_ids: Optional[Sequence[int]] = None,
) -> "nvsm_pb2.Metadata":
    """Assemble the lse.Metadata proto (data_indri.cpp:534-555 semantics:
    one TermInfo per model term, one ObjectInfo per model object;
    ``index_object_ids`` carries the external (Indri) document ids — when
    no external index exists, index_object_id == model_object_id)."""
    from cunvsm.proto import nvsm_pb2

    meta = nvsm_pb2.Metadata()
    for model_id, (iid, freq) in enumerate(
        zip(index_term_ids, term_frequencies)
    ):
        if include_oov and model_id == 0:
            # The OOV slot keeps index id 0 / frequency 1
            # (data_indri.cpp:812-822).
            iid, freq = 0, 1
        info = meta.term.add()
        info.index_term_id = int(iid)
        info.model_term_id = int(model_id)
        info.term_frequency = int(freq)
    for model_id in range(num_objects):
        obj = meta.object.add()
        obj.index_object_id = int(
            index_object_ids[model_id]
            if index_object_ids is not None
            else model_id
        )
        obj.model_object_id = int(model_id)
    meta.total_terms = int(total_terms)
    return meta


def save_meta(meta: "nvsm_pb2.Metadata", prefix: str) -> str:
    path = f"{prefix}_meta"
    with open(path, "wb") as f:
        f.write(meta.SerializeToString())
    return path


def load_meta(prefix: str) -> "nvsm_pb2.Metadata":
    from cunvsm.proto import nvsm_pb2

    meta = nvsm_pb2.Metadata()
    with open(f"{prefix}_meta", "rb") as f:
        meta.ParseFromString(f.read())
    return meta


def save_strings(strings: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        for s in strings:
            f.write(s + "\n")


def load_strings(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def save_corpus_sidecars(corpus, prefix: str) -> None:
    """Vocabulary terms + docnos in model-id order (framework extension)."""
    save_strings(corpus.vocab.terms, f"{prefix}_vocab.txt")
    save_strings(corpus.docnos, f"{prefix}_docnos.txt")
    if getattr(corpus, "stemmer", None):
        # The indexing-time stemmer of the source repository: query-time
        # tokenization must apply it to hit the stemmed vocabulary
        # (data/stemming.py; the reference's pyndri dictionary resolution
        # makes this implicit, py/query.py:111,141-142).
        save_strings([corpus.stemmer], f"{prefix}_stemmer.txt")


# ---------------------------------------------------------------------------
# Training-state resume (extension; the reference restarts from scratch).
# ---------------------------------------------------------------------------


def save_training_state(
    prefix: str,
    params: ModelParams,
    opt_state,
    epoch: int,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    import jax

    path = f"{prefix}_resume.npz"
    arrays: Dict[str, np.ndarray] = {"__epoch__": np.asarray(epoch)}
    flat, _ = jax.tree_util.tree_flatten((params, opt_state))
    for i, leaf in enumerate(flat):
        arrays[f"leaf_{i}"] = np.asarray(leaf)
    if extra:
        for k, v in extra.items():
            arrays[f"extra_{k}"] = v
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    return path


class AsyncCheckpointWriter:
    """Epoch-boundary checkpoint IO off the training thread.

    At the canonical collection-scale configuration (262k x 256 entity
    table, dense full_adam moments) the per-epoch resume npz alone is
    ~0.9 GB.  The caller's thread pays only a *device-side copy* of every
    array (milliseconds at HBM bandwidth; the copy breaks aliasing with
    the training step's donated buffers, so the next step can run
    immediately); the device-to-host transfer and all file writes happen
    on a single daemon worker in submission order.  Bounded queue (one
    epoch of lag max); worker exceptions propagate on the next
    ``save_*``/``wait`` (the FIRST failure is kept) — the same error
    contract as the data Prefetcher (data/sources.py).  Crash safety: both
    the .hdf5 and the resume .npz are written to temp names and renamed,
    so a process death mid-write (the async window) can only strand .tmp
    files, never a truncated file at a contract path — the same data-loss
    surface as a crash before a synchronous save."""

    def __init__(self, max_pending: int = 2):
        import queue
        import threading

        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                fn, args, kwargs = job
                fn(*args, **kwargs)
            except BaseException as exc:  # propagated to the caller
                if self._error is None:  # keep the FIRST failure
                    self._error = exc
            finally:
                self._queue.task_done()

    def _submit(self, fn, *args, **kwargs):
        self._raise_pending()
        self._queue.put((fn, args, kwargs))

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    @staticmethod
    def _snapshot(tree):
        import jax
        import jax.numpy as jnp

        def snap(leaf):
            if isinstance(leaf, jax.Array):
                if not leaf.is_fully_addressable:
                    # Multi-process: this process cannot pull the whole
                    # array, so gather it here on the TRAINING thread —
                    # process_allgather is a collective and every process
                    # calls save_* at the same epochs (matched control
                    # flow); only the primary then enqueues the file write.
                    from cunvsm.parallel.distributed import fetch

                    return fetch(leaf)
                # Device-side copy: asynchronous, HBM-bandwidth fast, and
                # independent of the donated training buffers.  The worker
                # pulls it to the host (np.asarray in the save functions).
                return jnp.copy(leaf)
            return np.asarray(leaf)

        return jax.tree_util.tree_map(snap, tree)

    def save_model(self, params: ModelParams, prefix: str, epoch,
                   overwrite: bool = False):
        from cunvsm.parallel.distributed import is_primary

        snap = self._snapshot(params)  # collective under multi-process
        if is_primary():
            self._submit(
                save_model_hdf5, snap, prefix, epoch, overwrite=overwrite,
            )

    def save_training_state(self, prefix: str, params, opt_state, epoch,
                            extra=None):
        from cunvsm.parallel.distributed import is_primary

        p_snap = self._snapshot(params)  # collective under multi-process
        o_snap = self._snapshot(opt_state)
        if is_primary():
            self._submit(
                save_training_state, prefix, p_snap, o_snap, epoch,
                extra=extra,
            )

    def wait(self):
        """Block until every submitted write has finished; re-raise any
        worker error."""
        self._queue.join()
        self._raise_pending()

    def close(self):
        self.wait()
        self._queue.put(None)
        self._thread.join()


def load_training_state(prefix: str, params_like, opt_state_like):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    path = f"{prefix}_resume.npz"
    data = np.load(path)
    flat_like, treedef = jax.tree_util.tree_flatten(
        (params_like, opt_state_like)
    )

    def restore(i, leaf):
        arr = data[f"leaf_{i}"].astype(leaf.dtype)
        # Mesh runs pass sharded like-trees: place each loaded array
        # straight onto its like-leaf's sharding (host->global device_put
        # also works when the sharding spans processes, where a plain
        # jnp.asarray would commit to one local device and conflict with
        # the step's in_shardings).
        sh = getattr(leaf, "sharding", None)
        if isinstance(sh, NamedSharding):
            return jax.device_put(arr, sh)
        return jnp.asarray(arr)

    leaves = [restore(i, leaf) for i, leaf in enumerate(flat_like)]
    params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    epoch = int(data["__epoch__"])
    extra = {
        k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")
    }
    return params, opt_state, epoch, extra
