"""Training-throughput benchmark on the canonical NVSM configuration.

Measures training-step throughput (forward + backward + full_adam update,
the SURVEY.md §3.1 hot loop) in n-gram->document training pairs per second
on one GPU, at the reference's published hyperparameters
(functions.sh:369-400 + the NVSM preset functions.sh:263-271): batch 51200,
window 10, d_word 300, d_entity 256, 10 negatives, vocab 65536, hard_tanh +
batch normalization, full_adam, over a collection-scale (262k-document)
entity table.

The step runs bfloat16 streams and window sums over float32 masters and
rolled-pool negative sampling with P=2048 (TrainConfig.negative_pool_size
-1, the trainer default): every instance still scores against exactly 10
uniform negatives with the reference's bias correction.
``--reference-exact`` measures the per-instance sampling path
(negative_pool_size=0) instead.

K=40 steps are chained inside one jit'd lax.scan, timed to a device-to-host
fetch of the final costs.

Baseline constant: the CUDA reference publishes no throughput numbers
(BASELINE.md); vs_baseline is anchored to an estimated 500k pairs/s for the
original single-GPU implementation (per-batch ~24 GFLOP of GEMMs plus an
atomicAdd scatter and dense Adam sweeps on an sm_52-era card at the same
batch size), so vs_baseline = measured / 5e5.

Fails when JAX finds no GPU.  Prints the card's name and power limit, then
one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

import argparse
import json
import sys
import time

import numpy as np

BASELINE_PAIRS_PER_SEC = 500_000.0

NUM_WORDS = 65536
NUM_ENTITIES = 262144  # collection scale (~Robust04 / 0.5M order)
SCAN_STEPS = 40


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--reference-exact", action="store_true",
        help="measure the reference-exact per-instance sampling path "
             "(negative_pool_size=0) instead of the shipped pooled "
             "layout, so regressions in the parity path stay visible",
    )
    args = ap.parse_args()

    import jax

    from cunvsm.cli._platform import device_record, enable_compile_cache

    enable_compile_cache()
    device = device_record()
    if device["platform"] != "gpu":
        print(f"no GPU (JAX's first device is {device['platform']})",
              file=sys.stderr)
        return 1
    print(device.pop("card"))

    import jax.numpy as jnp

    from cunvsm.config import (
        AdamConfig,
        AdamMode,
        ModelDesc,
        Nonlinearity,
        TrainConfig,
        UpdateMethod,
    )
    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import init_params
    from cunvsm.optim.updates import Optimizer
    from cunvsm.train.step import make_train_step

    desc = ModelDesc(
        word_repr_size=300,
        entity_repr_size=256,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=51200,
        window_size=10,
        num_random_entities=10,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3,
        regularization_lambda=1e-2,
        # Mixed-precision streams with float32 masters: Cranfield NVSM MAP
        # under bfloat16 streams sits inside the float32 seed spread
        # (PERFORMANCE.md), the fp32 fast-math release-build analog.
        stream_dtype="bfloat16",
        # Stream-width window accumulation: quality-validated seed-for-seed
        # against float32 on full Cranfield NVSM runs (PERFORMANCE.md).
        window_sum_dtype="bfloat16",
        # Canonical runs use UNIFORM feature weighting (functions.sh:395);
        # the static promise enables the packed accumulation sort.
        uniform_feature_weights=True,
        # Rolled-pool negatives: exact per-example loss (k=10), GEMM-
        # structured negative compute; Cranfield-validated at P=2048.
        # -1 = AUTO, the shipped TrainConfig default, which resolves to
        # P=2048 / stride 205 at this batch size — the bench measures the
        # literal trainer default.
        negative_pool_size=0 if args.reference_exact else -1,
    )

    key = jax.random.PRNGKey(0)
    params = init_params(key, NUM_WORDS, NUM_ENTITIES, desc)
    optimizer = Optimizer(cfg)
    opt_state = optimizer.init(params)
    step = make_train_step(desc, cfg, jit=False)

    rng = np.random.RandomState(0)
    B, W = cfg.batch_size, cfg.window_size
    batch = jax.device_put(
        TextEntityBatch(
            features=jnp.asarray(rng.randint(0, NUM_WORDS, (B, W)), jnp.int32),
            feature_weights=jnp.ones((B, W), jnp.float32),
            labels=jnp.asarray(
                rng.randint(0, NUM_ENTITIES, (B,)), jnp.int32
            ),
            weights=jnp.ones((B,), jnp.float32),
        )
    )

    def scan_steps(params, opt_state, batch, key):
        def body(carry, k):
            p, o = carry
            p, o, c = step(p, o, batch, k)
            return (p, o), c

        (p, o), costs = jax.lax.scan(
            body, (params, opt_state), jax.random.split(key, SCAN_STEPS)
        )
        return p, o, costs

    # AOT compile so XLA's own buffer assignment reports the program's
    # footprint (peak_memory_in_bytes: params, optimizer moments, temps).
    lowered = jax.jit(scan_steps, donate_argnums=(0, 1)).lower(
        params, opt_state, batch, key
    )
    compiled = lowered.compile()
    mem = compiled.memory_analysis()

    def run(p, o, b, k):
        return compiled(p, o, b, k)

    # Warmup (one real execution, verified by D2H).
    params, opt_state, costs = run(params, opt_state, batch, key)
    np.asarray(costs)

    # Best of three rounds.
    elapsed = float("inf")
    for round_idx in range(3):
        start = time.time()
        params, opt_state, costs = run(
            params, opt_state, batch, jax.random.PRNGKey(1 + round_idx)
        )
        costs = np.asarray(costs)  # device-to-host fetch ends the timing
        elapsed = min(elapsed, time.time() - start)
        assert np.all(np.isfinite(costs))

    pairs_per_sec = cfg.batch_size * SCAN_STEPS / elapsed

    # "Equal HBM" accounting (BASELINE.md quality-target clause): the CUDA
    # reference at full_adam holds every table plus dense Adam m and v in
    # f32 (updates_adam.cu:203-213 — 3x the f32 tables) plus the per-batch
    # forward/backward buffers.  3x-f32-tables is its floor:
    ref_tables = 4 * (
        NUM_WORDS * desc.word_repr_size
        + NUM_ENTITIES * desc.entity_repr_size
        + desc.word_repr_size * desc.entity_repr_size
        + desc.entity_repr_size
    )
    print(
        json.dumps(
            {
                "metric": (
                    "train_ngram_pairs_per_sec_reference_exact"
                    if args.reference_exact
                    else "train_ngram_pairs_per_sec"
                ),
                "value": round(pairs_per_sec, 1),
                "unit": "pairs/s",
                "vs_baseline": round(
                    pairs_per_sec / BASELINE_PAIRS_PER_SEC, 3
                ),
                "device": device,
                "hbm_peak_bytes": int(mem.peak_memory_in_bytes),
                "hbm_args_bytes": int(mem.argument_size_in_bytes),
                "hbm_temp_bytes": int(mem.temp_size_in_bytes),
                "hbm_reference_floor_bytes": 3 * ref_tables,
                "hbm_vs_reference_floor": round(
                    mem.peak_memory_in_bytes / (3 * ref_tables), 3
                ),
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
