"""Configuration dataclasses for cunvsm.

These mirror the reference protobuf configuration surface
(/root/reference/proto/nvsm.proto:7-84) so that every training recipe the
CUDA implementation supports can be expressed here, while remaining plain
Python objects that trace cleanly through jax (all fields that reach jit'd
code are static hashable values).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional


class Nonlinearity(enum.Enum):
    # Reference: nvsm.proto:12-15 (TransformDesc.Nonlinearity).
    TANH = "tanh"
    HARD_TANH = "hard_tanh"


class UpdateMethod(enum.Enum):
    # Reference: nvsm.proto:41-45 (TrainConfig.UpdateMethod).
    SGD = "sgd"
    ADAGRAD = "adagrad"
    ADAM = "adam"


class AdamMode(enum.Enum):
    """Sparse/dense handling of the representation tables under Adam.

    Reference: nvsm.proto:50-58 (AdamConf.AdamMode) and the CLI name map in
    main.cu:479-485 (sparse_adam / dense_adam / full_adam).
    """

    SPARSE = "sparse"
    DENSE_UPDATE = "dense_update"
    DENSE_UPDATE_DENSE_VARIANCE = "dense_update_dense_variance"


# CLI spelling -> (method, adam mode); reference main.cu:479-485.
UPDATE_METHOD_NAMES = {
    "sgd": (UpdateMethod.SGD, None),
    "adagrad": (UpdateMethod.ADAGRAD, None),
    "sparse_adam": (UpdateMethod.ADAM, AdamMode.SPARSE),
    "dense_adam": (UpdateMethod.ADAM, AdamMode.DENSE_UPDATE),
    "full_adam": (UpdateMethod.ADAM, AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
}


@dataclasses.dataclass(frozen=True)
class ModelDesc:
    """Model architecture description. Reference: nvsm.proto:7-29."""

    word_repr_size: int = 300
    entity_repr_size: int = 256

    batch_normalization: bool = False
    nonlinearity: Nonlinearity = Nonlinearity.TANH

    # Clip the NCE sigmoid into [eps, 1-eps]; the reference always enables
    # this from the CLI (main.cu:645 sets clip_sigmoid=true) but tests
    # exercise both settings.
    clip_sigmoid: bool = True

    # When False (and >1 negative sample), the loss reweights instances so
    # negative samples do not dominate (objective.cu:258-290).
    bias_negative_samples: bool = False

    l2_normalize_phrase_reprs: bool = False
    l2_normalize_entity_reprs: bool = False

    # Numeric constants used by the clipped sigmoid.  The reference uses a
    # *different* epsilon in the forward clip (1e-7, objective.cu:246) and
    # the backward zero-gradient test (1e-6, objective.cu:368); we replicate
    # both deliberately.
    sigmoid_eps_forward: float = 1e-7
    sigmoid_eps_backward: float = 1e-6

    # BatchNorm parameters (objective.cu:109-116): per-activation BN with
    # epsilon 1e-4, beta == the transform bias, gamma frozen at 1, and
    # training-mode statistics only.
    batch_norm_eps: float = 1e-4


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    mode: AdamMode = AdamMode.DENSE_UPDATE_DENSE_VARIANCE
    beta1: float = 0.9
    beta2: float = 0.999
    # DEFAULT_EPSILON in updates.h:21; note the reference adds eps *outside*
    # sqrt(v): update = m_hat / (sqrt(v) + eps).
    epsilon: float = 1e-6


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters. Reference: nvsm.proto:31-71."""

    num_epochs: int = 1
    batch_size: int = 1024

    window_size: int = 8
    num_random_entities: int = 1

    regularization_lambda: float = 0.01
    learning_rate: float = 0.0  # 0.0 -> per-optimizer default (main.cu:710-721)

    update_method: UpdateMethod = UpdateMethod.ADAM
    adam: AdamConfig = dataclasses.field(default_factory=AdamConfig)
    adagrad_epsilon: float = 1e-6

    no_shuffle: bool = False

    # Mixed precision for the HBM-bandwidth-bound streams: "bfloat16" runs
    # the embedding-table gathers, the NCE dot products, and the sparse
    # gradient-accumulation streams at half width while master tables,
    # optimizer moments, and every reduction stay float32 (the analog
    # of the reference's fp32 -use_fast_math release build,
    # cpp/CMakeLists.txt:20 + CMakeLists.txt:70-72).  "float32" (default)
    # disables all casts (tests run float64 through the same path).
    stream_dtype: str = "float32"

    # Batch-shared negative sampling: the k negatives are drawn once per
    # step and shared by every instance (GEMM-shaped NCE formulation — the
    # negative dots and negative-row gradients become GEMMs and the
    # entity scatter shrinks from B*k rows to k dense rows; on a mesh the
    # negative gather is a k-row broadcast instead of a cross-shard storm).
    # The per-example loss keeps the reference's exact form (1 positive +
    # k uniform negatives, same bias correction); only the cross-instance
    # correlation of the draws changes.  Off by default (note the default
    # *pooled* layout below still differs from per-instance sampling:
    # reference-parity runs must set negative_pool_size=0); requires an
    # accumulate-only optimizer (SGD or full_adam) and no entity L2
    # normalization.
    shared_negatives: bool = False

    # Rolled-pool negative sampling (mutually exclusive with
    # shared_negatives): draw a pool of P uniform negative ids per step;
    # instance b scores against the k = num_random_entities pool slots
    # (b % P) + j*stride (cyclic).  Keeps the reference's exact
    # per-example loss (k uniform negatives, same bias correction) while
    # the negative dots/gradients stay batched GEMMs and the entity-side
    # scatter is B + P rows instead of B * (k+1).  Values:
    #   -1 (default) AUTO — the pooled execution layout: the largest
    #      pool in {2048, 1024, ..., 64} dividing batch_size, when the
    #      optimizer is accumulate-only (sgd / full_adam), entity L2
    #      normalization is off, and shared_negatives is off; otherwise
    #      reference-exact per-instance sampling.  Quality-validated on
    #      Cranfield (PERFORMANCE.md quality table).
    #    0 reference-exact per-instance sampling, always.
    #   >0 explicit pool size; requires batch_size % P == 0, P >= k, an
    #      accumulate-only optimizer, and no entity L2 normalization.
    negative_pool_size: int = -1

    # Cross-chip reduce width of the word-gradient psum under a mesh:
    # "auto" (default) runs the [V, d_w] partial all-reduce in bfloat16
    # when stream_dtype is bfloat16 (the partials sum bf16-quantized
    # entries; per-chip accumulation stays float32) and float32 otherwise.
    # Explicit "float32"/"bfloat16" override.  Single-chip runs ignore it.
    cross_chip_reduce_dtype: str = "auto"

    # Reference-RNG replay (opt-in interop/debug mode): draw the per-epoch
    # instance order AND the per-instance negative labels on the host from
    # a bit-exact twin of the reference's std::minstd_rand0 stream
    # (data/stdrng.py; base.h:36, labels.cu:3-22, data_indri.cpp:385-397),
    # seeded with `seed`.  Gives label-stream/instance-order parity with
    # the CUDA binary for the same seed (tests/test_reference_rng.py pins
    # the seed-1 stream).  Forces per-instance negative sampling; host
    # pipeline only (incompatible with on_device_sampling); slower — for
    # cross-validation, not production.
    reference_rng: bool = False

    # Slot stride of the rolled-pool windows: instance with residue r
    # scores against pool slots (r + j*stride) % P for j in [0, k).
    # 0 (default) AUTO: about P // k, adjusted upward until the k slots
    # are distinct mod P — spreads each pool row's k consuming windows
    # across distant residues, decorrelating the per-step
    # negative-gradient noise between instances at zero cost (the fold
    # stays k rolls, by j*stride instead of j).  1 gives consecutive
    # windows (adjacent residues overlap k-1 slots).  The per-example
    # loss distribution is unchanged for any valid stride: every
    # instance scores k distinct iid-uniform pool slots.
    negative_pool_stride: int = 0

    # Static promise that every batch's feature_weights are all ones (the
    # UNIFORM feature-weighting strategy, the reference's default and the
    # canonical NVSM/LSE configuration, functions.sh:369-400).  When set,
    # the objective skips the weight multiply in the window average and the
    # word-gradient scatter descriptor drops its weights operand, which
    # unlocks a single-operand packed sort in the gradient accumulation
    # (optim/updates.py).  The trainer sets this automatically from the
    # feature-weighting strategy; it must never be combined with
    # self-information weights.
    uniform_feature_weights: bool = False

    # Accumulator dtype of the forward window average (gather_phrase_reprs).
    # The default float32 widening forces XLA on this toolchain to
    # materialize a full-width copy of the gathered word stream before the
    # reduce (~614 MB/step at the canonical configuration); "bfloat16" sums
    # the 10-element window at stream width and widens after (worst-case
    # relative error ~2^-8 * window/2, absorbed by the batch-norm that
    # follows in the NVSM configuration).  Only meaningful with
    # stream_dtype=bfloat16; quality-validate before enabling (see
    # PERFORMANCE.md).
    window_sum_dtype: str = "float32"

    # Accumulator dtype for the full_adam dense segment accumulation.
    # "bfloat16" keeps the sorted scatter itself at stream width — the
    # float32 up-convert otherwise materializes a full-width update stream
    # (HLO-verified; optim/updates.py) — trading half-precision partial
    # sums (relative error ~2^-9 * sqrt(updates per row)).  Default
    # "float32": exact accumulation.
    accum_dtype: str = "float32"

    # Multi-objective ("Mix 'n Match", CIKM 2018) mixture weights.
    text_entity_weight: float = 1.0
    entity_entity_weight: float = 0.0
    term_term_weight: float = 0.0

    seed: int = 1

    def __post_init__(self):
        # window_sum_dtype only takes effect when it matches the resolved
        # stream dtype (gather_phrase_reprs sums at stream width); a
        # mismatch would silently no-op — the misconfigured quality
        # experiment would measure the wrong thing.
        if (
            self.window_sum_dtype != "float32"
            and self.window_sum_dtype != self.stream_dtype
        ):
            raise ValueError(
                f"window_sum_dtype={self.window_sum_dtype!r} requires "
                f"stream_dtype={self.window_sum_dtype!r} "
                f"(got {self.stream_dtype!r}); the window sum runs at "
                "stream width or at float32, never at a third dtype"
            )

    def resolved_stream_dtype(self) -> Optional[str]:
        """None when no stream casting is requested (the default)."""
        return None if self.stream_dtype == "float32" else self.stream_dtype

    def resolved_accum_dtype(self) -> Optional[str]:
        return None if self.accum_dtype == "float32" else self.accum_dtype

    def resolved_window_sum_dtype(self) -> Optional[str]:
        return (
            None
            if self.window_sum_dtype == "float32"
            else self.window_sum_dtype
        )

    def resolved_cross_chip_reduce_dtype(self) -> Optional[str]:
        """Element type of the cross-chip word-gradient psum under a mesh
        (None = full width).  "auto" reduces in bfloat16 exactly when the
        gradient streams are already bfloat16-quantized (stream_dtype):
        the [V, d_w] partial-sum all-reduce is the largest per-step
        collective (PERFORMANCE.md comm table) and halving its width
        halves it; each chip still accumulates its local partial in
        float32, so only the N_dev-way cross-chip sum runs at stream
        width."""
        if self.cross_chip_reduce_dtype == "auto":
            return "bfloat16" if self.stream_dtype == "bfloat16" else None
        if self.cross_chip_reduce_dtype == "float32":
            return None
        if self.cross_chip_reduce_dtype != "bfloat16":
            # Validate here, not deep inside jit tracing after the
            # 30-400 s remote compile has started.
            raise ValueError(
                "cross_chip_reduce_dtype must be 'auto', 'float32', or "
                f"'bfloat16' (got {self.cross_chip_reduce_dtype!r})"
            )
        return self.cross_chip_reduce_dtype

    def resolved_learning_rate(self) -> float:
        if self.learning_rate != 0.0:
            return self.learning_rate
        # Reference defaults: SGD/Adagrad 0.01, Adam 0.001 (main.cu:710-721).
        if self.update_method == UpdateMethod.ADAM:
            return 0.001
        return 0.01


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Corpus ingestion configuration. Reference: nvsm.proto:73-84.

    `corpus_path` replaces the Indri `repository_path`: it points at a
    TRECTEXT file/directory, a JSONL file, or a packed corpus directory.
    """

    corpus_path: str = ""

    max_vocabulary_size: int = 60000
    min_document_frequency: int = 2
    # <= 1.0 means a fraction of the corpus document count (main.cu:665-677).
    max_document_frequency: float = 0.5

    include_oov: bool = False
    include_digits: bool = False

    documents_cutoff: int = 0
    document_list: Optional[str] = None
    term_blacklist: Optional[str] = None

    similarity_path: Optional[str] = None


def _as_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _as_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _as_jsonable(v) for k, v in obj.items()}
    return obj


def config_to_json(*configs) -> str:
    return json.dumps([_as_jsonable(c) for c in configs], indent=2, sort_keys=True)
