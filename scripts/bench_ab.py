"""Whole-program A/B of canonical-step variants on one GPU.

Each variant runs in a fresh subprocess (CUNVSM_ACCUM_VARIANT is read at
trace time) and measures exactly what bench.py measures: 20 steps chained
in one lax.scan with a device-to-host barrier, best of three rounds.

Usage: python scripts/bench_ab.py [--variants v0,v1,...] [--rounds 3]

Variants:
  base       shipped defaults (bf16 streams, f32 accum, packed/auto sorts)
  nouniform  uniform_feature_weights off (the round-2 shipped layout)
  twoop      CUNVSM_ACCUM_VARIANT=twoop (entity sort 2-operand + wts gather)
  accbf16    accum_dtype=bfloat16
  twoop_acc  both of the above
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys, time
import numpy as np

variant = json.loads(sys.argv[1])

import jax
import jax.numpy as jnp

from cunvsm.cli._platform import enable_compile_cache

enable_compile_cache()

from cunvsm.config import (
    AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig, UpdateMethod,
)
from cunvsm.models.objectives import TextEntityBatch
from cunvsm.models.params import init_params
from cunvsm.optim.updates import Optimizer
from cunvsm.train.step import make_train_step

NUM_WORDS, NUM_ENTITIES, SCAN_STEPS = 65536, 262144, 20

desc = ModelDesc(
    word_repr_size=300, entity_repr_size=256,
    nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
)
cfg = TrainConfig(
    batch_size=51200, window_size=10,
    num_random_entities=variant.get("num_negatives", 10),
    update_method=UpdateMethod.ADAM,
    adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
    learning_rate=1e-3, regularization_lambda=1e-2,
    stream_dtype=variant.get("stream_dtype", "bfloat16"),
    accum_dtype=variant.get("accum_dtype", "float32"),
    uniform_feature_weights=variant.get("uniform", True),
    window_sum_dtype=variant.get("window_sum_dtype", "float32"),
    shared_negatives=variant.get("shared", False),
    negative_pool_size=variant.get("pool", 0),  # explicit: 0 = per-instance
    negative_pool_stride=variant.get("pool_stride", 1),
)

key = jax.random.PRNGKey(0)
params = init_params(key, NUM_WORDS, NUM_ENTITIES, desc)
optimizer = Optimizer(cfg)
opt_state = optimizer.init(params)
step = make_train_step(desc, cfg, jit=False)

rng = np.random.RandomState(0)
B, W = cfg.batch_size, cfg.window_size
batch = jax.device_put(TextEntityBatch(
    features=jnp.asarray(rng.randint(0, NUM_WORDS, (B, W)), jnp.int32),
    feature_weights=jnp.ones((B, W), jnp.float32),
    labels=jnp.asarray(rng.randint(0, NUM_ENTITIES, (B,)), jnp.int32),
    weights=jnp.ones((B,), jnp.float32),
))

def scan_steps(params, opt_state, batch, key):
    def body(carry, k):
        p, o = carry
        p, o, c = step(p, o, batch, k)
        return (p, o), c
    (p, o), costs = jax.lax.scan(
        body, (params, opt_state), jax.random.split(key, SCAN_STEPS))
    return p, o, costs

run = jax.jit(scan_steps, donate_argnums=(0, 1))
params, opt_state, costs = run(params, opt_state, batch, key)
np.asarray(costs)

elapsed = float("inf")
for i in range(int(variant.get("rounds", 3))):
    start = time.time()
    params, opt_state, costs = run(
        params, opt_state, batch, jax.random.PRNGKey(1 + i))
    costs = np.asarray(costs)
    elapsed = min(elapsed, time.time() - start)
    assert np.all(np.isfinite(costs)), costs

pairs = cfg.batch_size * SCAN_STEPS / elapsed
print(json.dumps({
    "name": variant["name"], "ms_per_step": round(elapsed / SCAN_STEPS * 1e3, 2),
    "pairs_per_sec": round(pairs, 0),
}))
"""

VARIANTS = {
    "base": {},
    "nouniform": {"uniform": False},
    "twoop": {"env": "twoop"},
    "accbf16": {"accum_dtype": "bfloat16"},
    "twoop_acc": {"env": "twoop", "accum_dtype": "bfloat16"},
    "f32base": {"stream_dtype": "float32"},
    "wsum": {"window_sum_dtype": "bfloat16"},
    "shared": {"shared": True},
    "shared1024": {"shared": True, "num_negatives": 1024},
    "shared_wsum": {"shared": True, "window_sum_dtype": "bfloat16"},
    "shared_wsum_acc": {
        "shared": True, "window_sum_dtype": "bfloat16",
        "accum_dtype": "bfloat16",
    },
    "pool1024_wsum": {"pool": 1024, "window_sum_dtype": "bfloat16"},
    "pool2048_wsum": {"pool": 2048, "window_sum_dtype": "bfloat16"},
    "pool6400_wsum": {"pool": 6400, "window_sum_dtype": "bfloat16"},
    "pool12800_wsum": {"pool": 12800, "window_sum_dtype": "bfloat16"},
    # Round 3: the opt-in prefix-diff word accumulation (pd_* variants
    # force CUNVSM_PREFIX_DIFF=1) A/B'd against the shipped sorted-scatter
    # path (nopd_*), across pool sizes / strides / chunk sizes.
    "pd_pool2048": {
        "pool": 2048, "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1"},
    },
    "nopd_pool2048": {"pool": 2048, "window_sum_dtype": "bfloat16"},
    "pd_perinst": {
        "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1"},
    },
    "nopd_perinst": {"window_sum_dtype": "bfloat16"},
    "pd_pool5120": {
        "pool": 5120, "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1"},
    },
    "pd_pool2048_s205": {
        "pool": 2048, "pool_stride": 205, "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1"},
    },
    "pd_chunk64": {
        "pool": 2048, "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1", "CUNVSM_PREFIX_CHUNK": "64"},
    },
    "pd_chunk256": {
        "pool": 2048, "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1", "CUNVSM_PREFIX_CHUNK": "256"},
    },
    "pd_chunk512": {
        "pool": 2048, "window_sum_dtype": "bfloat16",
        "envs": {"CUNVSM_PREFIX_DIFF": "1", "CUNVSM_PREFIX_CHUNK": "512"},
    },
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default="nouniform,base,twoop,accbf16")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in args.variants.split(","):
        spec = dict(VARIANTS[name])
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        if "env" in spec:
            env["CUNVSM_ACCUM_VARIANT"] = spec.pop("env")
        for k, v in spec.pop("envs", {}).items():
            env[k] = v
        spec["name"] = name
        spec["rounds"] = args.rounds
        r = subprocess.run(
            [sys.executable, "-c", CHILD, json.dumps(spec)],
            env=env, capture_output=True, text=True,
        )
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(json.dumps({"name": name, "error": r.stderr[-2000:]}) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
