"""cunvsm: an accelerator-native NVSM/LSE unsupervised neural retrieval framework.

A ground-up jax/XLA rebuild of the capabilities of cvangysel/cuNVSM
(NVSM, TOIS 2018; LSE, CIKM 2016; Mix 'n Match multi-objective training,
CIKM 2018): corpus ingestion, n-gram-to-document representation learning,
HDF5-interoperable checkpoints, and an on-device brute-force query engine.
"""

from cunvsm.config import (
    AdamConfig,
    AdamMode,
    DataConfig,
    ModelDesc,
    Nonlinearity,
    TrainConfig,
    UpdateMethod,
)
from cunvsm.models.params import ModelParams, init_params
from cunvsm.models.objectives import (
    AscentGrads,
    SimilarityBatch,
    SparseGrad,
    TextEntityBatch,
)
from cunvsm.optim.updates import Optimizer, OptState
from cunvsm.train.step import (
    ObjectiveKind,
    make_cost_fn,
    make_train_step,
    objective_kind_from_config,
)

__version__ = "0.2.0"
