"""Device-trace profile of the canonical training step on one GPU.

Runs the canonical pooled NVSM step under ``jax.profiler.trace`` and prints
the device time of each kernel and each HLO op, summed from the trace's
GPU planes, with the device's busy and idle share over the traced window.
Toggle code paths via env (CUNVSM_PREFIX_DIFF=1, CUNVSM_PREFIX_CHUNK=...,
CUNVSM_ACCUM_VARIANT=...).

Usage: python scripts/profile_step.py [--pool 2048] [--steps 10]
       [--top 40] [--outdir build/trace_step]
"""

import argparse
import glob
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run(args):
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
        stream_dtype="bfloat16", window_sum_dtype="bfloat16",
        uniform_feature_weights=True,
        negative_pool_size=args.pool,
        negative_pool_stride=args.pool_stride,
    )
    params = init_params(jax.random.PRNGKey(0), NUM_WORDS, NUM_ENTITIES, desc)
    optimizer = Optimizer(cfg)
    opt_state = optimizer.init(params)
    step = make_train_step(desc, cfg, jit=False)

    rng = np.random.RandomState(0)
    B, W = cfg.batch_size, cfg.window_size

    if args.device_sampling:
        # The FULL E2E program: K steps each sampling their own batch from
        # a device-resident synthetic corpus (the path
        # scripts/e2e_throughput.py trains with), so the trace shows the
        # batch-construction ops responsible for the E2E-vs-step gap.
        from cunvsm.data.device_sampler import (
            make_device_sampled_multistep,
            make_epoch_permuter,
            prepare_device_corpus,
        )
        from cunvsm.data.synth import uniform_corpus

        corpus = uniform_corpus(
            NUM_ENTITIES, 120, NUM_WORDS, window_size=W, seed=0
        )
        dc = prepare_device_corpus(corpus)
        permuter, _ = make_epoch_permuter(dc)
        doc_perm = permuter(jax.random.PRNGKey(3))
        runf = make_device_sampled_multistep(
            desc, cfg, dc, args.steps, num_entities=NUM_ENTITIES
        )
        params, opt_state, costs = runf(
            params, opt_state, jax.random.PRNGKey(0), doc_perm, 0
        )
        np.asarray(costs)
        os.makedirs(args.outdir, exist_ok=True)
        with jax.profiler.trace(args.outdir):
            params, opt_state, costs = runf(
                params, opt_state, jax.random.PRNGKey(1), doc_perm,
                args.steps * cfg.batch_size,
            )
            np.asarray(costs)
        return args.steps

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
            body, (params, opt_state), jax.random.split(key, args.steps))
        return p, o, costs

    runf = jax.jit(scan_steps, donate_argnums=(0, 1))
    params, opt_state, costs = runf(params, opt_state, batch,
                                    jax.random.PRNGKey(0))
    np.asarray(costs)  # D2H barrier after compile+first run

    os.makedirs(args.outdir, exist_ok=True)
    with jax.profiler.trace(args.outdir):
        params, opt_state, costs = runf(params, opt_state, batch,
                                        jax.random.PRNGKey(1))
        np.asarray(costs)
    return args.steps


def device_summary(outdir):
    """Reduce the newest trace under ``outdir`` to device time.

    Kernels are the events on the GPU planes' stream lines; the "XLA Ops"
    line attributes the same time to HLO ops.  Busy time is the union of the
    kernel intervals of each device; idle share is 1 - busy / window, with
    the window from the first kernel start to the last kernel end.
    Returns {"devices": {plane: {...}}} with nanosecond totals.
    """
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(
        os.path.join(outdir, "plugins/profile/*/*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {outdir}")
    data = ProfileData.from_file(paths[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        kernels = defaultdict(lambda: [0, 0])
        ops = defaultdict(lambda: [0, 0])
        intervals = []
        for line in plane.lines:
            if line.name.startswith("Stream"):
                for e in line.events:
                    kernels[e.name][0] += e.duration_ns
                    kernels[e.name][1] += 1
                    intervals.append((e.start_ns, e.end_ns))
            elif line.name == "XLA Ops":
                for e in line.events:
                    ops[e.name][0] += e.duration_ns
                    ops[e.name][1] += 1
        if not intervals:
            continue
        intervals.sort()
        busy, cur_start, cur_end = 0.0, *intervals[0]
        for start, end in intervals[1:]:
            if start > cur_end:
                busy += cur_end - cur_start
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        busy += cur_end - cur_start
        window = max(e for _, e in intervals) - intervals[0][0]
        out[plane.name] = {
            "window_ns": window,
            "busy_ns": busy,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "kernels": dict(kernels),
            "ops": dict(ops),
        }
    return {"trace": paths[-1], "devices": out}


def parse(outdir, steps, top):
    summary = device_summary(outdir)
    for plane, d in summary["devices"].items():
        print(f"# {plane}: busy {d['busy_ns'] / 1e6:.3f} ms of a "
              f"{d['window_ns'] / 1e6:.3f} ms window (idle share "
              f"{d['idle_share']:.3f}), {steps} steps")
        for title, table in (("kernels", d["kernels"]), ("HLO ops", d["ops"])):
            print(f"# top {title} (ms total over the trace):")
            ranked = sorted(table.items(), key=lambda kv: -kv[1][0])
            for name, (ns, n) in ranked[:top]:
                print(f"{ns / 1e6:9.3f} ms  x{n:<5d} {name[:130]}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pool", type=int, default=2048)
    p.add_argument("--pool_stride", type=int, default=1)
    p.add_argument("--device_sampling", action="store_true",
                   help="profile the full E2E program (on-device batch "
                        "sampling inside the scanned step)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--outdir", default="build/trace_step")
    p.add_argument("--parse_only", action="store_true")
    args = p.parse_args()
    if not args.parse_only:
        from cunvsm.cli._platform import enable_compile_cache

        enable_compile_cache()
        run(args)
    parse(args.outdir, args.steps, args.top)


if __name__ == "__main__":
    main()
