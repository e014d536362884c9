"""Measured steady-state end-to-end training throughput at collection scale.

bench.py measures the compiled device *step*; this script measures the full
*training loop* the way the reference logs it (epoch wall-clock and
batches/sec, cpp/main.cu:598-612): a collection-scale synthetic corpus
(262k documents, canonical NVSM hyperparameters), on-device epoch-exact
sampling, multi-step scan, async checkpointing — run for enough epochs that
the one-time compile amortizes, reporting measured steady-state pairs/s
next to the device-step rate.

Corpus: Zipf-distributed tokens over the canonical 65536-term vocabulary
(inverse-CDF sampling; duplicate-heavy scatter streams like real text),
fixed document length ``--doc_len`` (default 120 -> 111 sampled windows per
document per epoch, 568 steps of 51200 pairs per epoch at canonical batch).

Outputs one JSON object to --out (and stdout) with:
  * per-epoch wall-clock list (epoch 1 includes the one-time compile),
  * steady-state pairs/s = epoch pairs / median(epoch 2.. durations),
  * checkpoint snapshot + drain accounting (the D2H pull runs on the async
    writer's worker thread; reported separately so the training-thread
    numbers stay honest),
  * the device it ran on (platform, device kind, count, and on a GPU the
    card's name and power limit).

Usage (GPU):
  python scripts/e2e_throughput.py --out build/e2e.json
Smoke (CPU):
  python scripts/e2e_throughput.py --platform cpu --num_docs 2048 \
      --batch_size 512 --epochs 3 --steps_per_call 4 --out /tmp/e2e.json
"""

import argparse
import json
import logging
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

VOCAB = 65536


def make_corpus(num_docs: int, doc_len: int, gen_seed: int = 4242):
    from cunvsm.data.synth import zipf_corpus

    return zipf_corpus(num_docs, doc_len, VOCAB, seed=gen_seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_docs", type=int, default=262144)
    ap.add_argument("--doc_len", type=int, default=120)
    ap.add_argument("--batch_size", type=int, default=51200)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument(
        "--checkpoint_every", type=int, default=5,
        help="epoch-checkpoint cadence; 0 disables checkpointing entirely",
    )
    ap.add_argument(
        "--mesh", default=None,
        help="DATAxMODEL (e.g. 2x4): measure the sharded E2E path over a "
             "device mesh — the one-command multi-chip measurement for "
             "when multi-chip hardware is available.  CPU-smokeable only "
             "at reduced dims (e.g. --word_repr_size 16 "
             "--entity_repr_size 16) via JAX_PLATFORMS=cpu XLA_FLAGS="
             "--xla_force_host_platform_device_count=8: at canonical "
             "dims the XLA:CPU thunk executor schedules independent "
             "collectives in device-dependent order and its rendezvous "
             "deadlocks (40 s timeout abort) — a virtual-device-backend "
             "artifact, not a program bug (tests/test_sharding.py + the "
             "multichip dryrun cover the sharded program's correctness).",
    )
    ap.add_argument("--shard_corpus", action="store_true",
                    help="with --mesh: shard the device-resident corpus "
                         "over the data axis (each chip holds only its "
                         "document group's tokens — multi-card memory; "
                         "data.device_sampler.ShardedDeviceCorpus)")
    ap.add_argument("--word_repr_size", type=int, default=300)
    ap.add_argument("--entity_repr_size", type=int, default=256)
    ap.add_argument("--platform", default=None)
    from cunvsm.cli._platform import (
        add_distributed_flags, apply_distributed, apply_platform,
        device_record,
    )

    add_distributed_flags(ap)
    args = ap.parse_args(argv)

    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    apply_platform(args)
    apply_distributed(args)  # multi-host: before any backend use

    from cunvsm.config import (
        AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig,
        UpdateMethod,
    )
    from cunvsm.train.trainer import train_model

    corpus = make_corpus(args.num_docs, args.doc_len)
    logging.info(
        "Corpus: %d docs x %d tokens = %d total tokens.",
        args.num_docs, args.doc_len, len(corpus.tokens),
    )
    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH, batch_normalization=True,
    )
    cfg = TrainConfig(
        num_epochs=args.epochs, batch_size=args.batch_size, window_size=10,
        num_random_entities=10, regularization_lambda=1e-2,
        learning_rate=1e-3, update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=1, stream_dtype="bfloat16", window_sum_dtype="bfloat16",
    )

    epoch_wall = []
    last = [None]

    def cb(epoch, params, cost):
        now = time.time()
        if last[0] is not None:
            epoch_wall.append(round(now - last[0], 2))
        last[0] = now

    workdir = tempfile.mkdtemp(prefix="e2e_")
    prefix = (
        os.path.join(workdir, "model") if args.checkpoint_every else None
    )
    samples_per_doc = max(args.doc_len - 10 + 1, 1)  # ceil(avg - w + 1)
    # The trainer trains EVERY epoch step (a non-dividing steps_per_call
    # runs the remainder as one extra compiled call), so pairs/s counts
    # the full epoch.
    steps_per_epoch = max(
        args.num_docs * samples_per_doc // args.batch_size, 1
    )
    pairs_per_epoch = steps_per_epoch * args.batch_size

    mesh = None
    if args.mesh:
        from cunvsm.parallel.mesh import make_mesh

        d, m = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(d, m)

    start = time.time()
    last[0] = start
    result = train_model(
        desc, cfg, corpus,
        output_prefix=prefix,
        on_device_sampling=True,
        steps_per_call=args.steps_per_call,
        checkpoint_every=args.checkpoint_every or 10**9,
        epoch_callback=cb,
        mesh=mesh,
        shard_corpus=args.shard_corpus,
    )
    loop_done = time.time()
    # train_model's finally has already drained the async writer by the
    # time it returns; measure the post-loop tail (writer drain) as the
    # difference between the last epoch callback and return.
    drain_s = loop_done - last[0]
    total_s = loop_done - start

    steady = sorted(epoch_wall[1:]) if len(epoch_wall) > 1 else epoch_wall
    steady_epoch_s = steady[len(steady) // 2] if steady else None
    out = {
        "metric": "e2e_train_pairs_per_sec_steady_state",
        "value": (
            round(pairs_per_epoch / steady_epoch_s, 1)
            if steady_epoch_s else None
        ),
        "unit": "pairs/s",
        "num_docs": args.num_docs,
        "batch_size": args.batch_size,
        "steps_per_call": args.steps_per_call,
        "steps_per_epoch": steps_per_epoch,
        "pairs_per_epoch": pairs_per_epoch,
        "epochs": args.epochs,
        "epoch_wall_s": epoch_wall,
        "epoch1_incl_compile_s": epoch_wall[0] if epoch_wall else None,
        "steady_epoch_s": steady_epoch_s,
        "checkpoint_every": args.checkpoint_every,
        "writer_drain_s": round(drain_s, 1),
        "total_wall_s": round(total_s, 1),
        "final_cost": result.epoch_costs[-1] if result.epoch_costs else None,
        "device": device_record(),
        "mesh": args.mesh,
        "shard_corpus": args.shard_corpus,
    }
    from cunvsm.parallel.distributed import is_primary

    if is_primary():  # one writer under multi-process
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
