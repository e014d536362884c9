"""Stream-dtype ablation of the canonical training step on one GPU.

Measures the canonical NVSM step (bench.py configuration) with float32 or
bfloat16 streams (mixed-precision gathers + gradient streams).

Usage: python scripts/bench_ablate.py [--steps 20] [--stream bfloat16]
Writes one JSON line to stdout.  Methodology identical to bench.py:
scan-chained steps, timed to a device-to-host fetch.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def measure(stream_dtype: str, scan_steps: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cunvsm.config import (
        AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig,
        UpdateMethod,
    )
    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import init_params
    from cunvsm.optim.updates import Optimizer
    from cunvsm.train.step import make_train_step

    NUM_WORDS, NUM_ENTITIES = 65536, 262144
    desc = ModelDesc(
        word_repr_size=300, entity_repr_size=256,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=51200, window_size=10, num_random_entities=10,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3, regularization_lambda=1e-2,
        stream_dtype=stream_dtype,
    )
    params = init_params(jax.random.PRNGKey(0), NUM_WORDS, NUM_ENTITIES, desc)
    opt_state = Optimizer(cfg).init(params)
    step = make_train_step(desc, cfg, jit=False)

    rng = np.random.RandomState(0)
    B, W = cfg.batch_size, cfg.window_size
    batch = jax.device_put(TextEntityBatch(
        features=jnp.asarray(rng.randint(0, NUM_WORDS, (B, W)), jnp.int32),
        feature_weights=jnp.ones((B, W), jnp.float32),
        labels=jnp.asarray(rng.randint(0, NUM_ENTITIES, (B,)), jnp.int32),
        weights=jnp.ones((B,), jnp.float32),
    ))

    def scan_steps_fn(params, opt_state, batch, key):
        def body(carry, k):
            p, o = carry
            p, o, c = step(p, o, batch, k)
            return (p, o), c
        (p, o), costs = jax.lax.scan(
            body, (params, opt_state), jax.random.split(key, scan_steps)
        )
        return p, o, costs

    run = jax.jit(scan_steps_fn, donate_argnums=(0, 1))
    t0 = time.time()
    params, opt_state, costs = run(params, opt_state, batch, jax.random.PRNGKey(0))
    np.asarray(costs)
    compile_s = time.time() - t0

    start = time.time()
    params, opt_state, costs = run(params, opt_state, batch, jax.random.PRNGKey(1))
    costs = np.asarray(costs)
    elapsed = time.time() - start
    assert np.all(np.isfinite(costs)), costs

    return {
        "stream_dtype": stream_dtype,
        "ms_per_step": round(1000 * elapsed / scan_steps, 2),
        "pairs_per_sec": round(B * scan_steps / elapsed, 1),
        "compile_s": round(compile_s, 1),
        "last_cost": round(float(costs[-1]), 4),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--stream", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    from cunvsm.cli._platform import enable_compile_cache

    enable_compile_cache()
    r = measure(args.stream, args.steps)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    sys.exit(main())
