"""Phase-cost ablation of the training step on one GPU.

DEPRECATED as a measurement method: program-prefix ablations are not
additive (fusion and scheduling differ across prefixes).  Use
``jax.profiler.trace`` on the full step instead (scripts/profile_step.py
reduces it to per-kernel device time).  Kept for the prefix-compilation
smoke value only.

Times progressively larger prefixes of the canonical NVSM step so phase
costs emerge by subtraction (each program scans 20 iterations with a D2H
barrier, like bench.py):

  fwdbwd   forward + backward only (gradient reductions keep it live)
  wordacc  + word-table segment accumulation
  bothacc  + entity-table segment accumulation
  full     the complete step (accumulate + dense full_adam sweeps)

Usage: python scripts/bench_phases.py [--stream bfloat16] [--phase X]
"""

import argparse
import json
import sys
import time


def build(stream_dtype):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cunvsm.config import (
        AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig,
        UpdateMethod,
    )
    from cunvsm.models import objectives as obj
    from cunvsm.models.params import init_params
    from cunvsm.optim.updates import (
        Optimizer, _sorted_segment_accumulate,
    )

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
    sd = cfg.resolved_stream_dtype()
    params = init_params(jax.random.PRNGKey(0), NUM_WORDS, NUM_ENTITIES, desc)
    optimizer = Optimizer(cfg)
    opt_state = optimizer.init(params)

    rng = np.random.RandomState(0)
    B, W = cfg.batch_size, cfg.window_size
    batch = jax.device_put(obj.TextEntityBatch(
        features=jnp.asarray(rng.randint(0, NUM_WORDS, (B, W)), jnp.int32),
        feature_weights=jnp.ones((B, W), jnp.float32),
        labels=jnp.asarray(rng.randint(0, NUM_ENTITIES, (B,)), jnp.int32),
        weights=jnp.ones((B,), jnp.float32),
    ))

    def grads_of(params, key):
        ids = obj.sample_negative_entities(
            key, batch.labels, NUM_ENTITIES, cfg.num_random_entities
        )
        cost, _, grads = obj.text_entity_cost_and_grads(
            params, batch, ids, desc, factored_entity_grads=True,
        )
        return cost, grads

    def fwdbwd(params, opt_state, key):
        cost, g = grads_of(params, key)
        # Keep every gradient live with cheap reductions.
        live = (cost + jnp.sum(g.transform_w) + jnp.sum(g.transform_b)
                + jnp.sum(g.word[0].grad) + jnp.sum(g.entity[0].grad)
                + jnp.sum(g.entity[0].weights))
        return params, opt_state, live

    def wordacc(params, opt_state, key):
        cost, g = grads_of(params, key)
        s_w = _sorted_segment_accumulate(NUM_WORDS, g.word, sd)
        live = (cost + jnp.sum(s_w) + jnp.sum(g.transform_w)
                + jnp.sum(g.entity[0].grad) + jnp.sum(g.entity[0].weights))
        return params, opt_state, live

    def bothacc(params, opt_state, key):
        cost, g = grads_of(params, key)
        s_w = _sorted_segment_accumulate(NUM_WORDS, g.word, sd)
        s_e = _sorted_segment_accumulate(NUM_ENTITIES, g.entity, sd)
        live = cost + jnp.sum(s_w) + jnp.sum(s_e) + jnp.sum(g.transform_w)
        return params, opt_state, live

    def full(params, opt_state, key):
        cost, g = grads_of(params, key)
        params, opt_state = optimizer.apply(
            params, opt_state, g, cfg.resolved_learning_rate(),
            cfg.regularization_lambda / cfg.batch_size,
        )
        return params, opt_state, cost

    return params, opt_state, {
        "fwdbwd": fwdbwd, "wordacc": wordacc, "bothacc": bothacc,
        "full": full,
    }, cfg


def measure(phase, stream_dtype, scan_steps=20):
    import jax
    import jax.numpy as jnp
    import numpy as np

    params, opt_state, fns, cfg = build(stream_dtype)
    step = fns[phase]

    def scan_fn(params, opt_state, key):
        def body(carry, k):
            p, o = carry
            p, o, c = step(p, o, k)
            return (p, o), c
        (p, o), costs = jax.lax.scan(
            body, (params, opt_state), jax.random.split(key, scan_steps)
        )
        return p, o, costs

    run = jax.jit(scan_fn, donate_argnums=(0, 1))
    t0 = time.time()
    params, opt_state, costs = run(params, opt_state, jax.random.PRNGKey(0))
    np.asarray(costs)
    compile_s = time.time() - t0
    t0 = time.time()
    params, opt_state, costs = run(params, opt_state, jax.random.PRNGKey(1))
    np.asarray(costs)
    dt = time.time() - t0
    return {
        "phase": phase, "stream_dtype": stream_dtype,
        "ms_per_step": round(1000 * dt / scan_steps, 2),
        "compile_s": round(compile_s, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", required=True)
    ap.add_argument("--stream", default="bfloat16")
    args = ap.parse_args()
    from cunvsm.cli._platform import enable_compile_cache

    enable_compile_cache()
    print(json.dumps(measure(args.phase, args.stream)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
