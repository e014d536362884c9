"""Subprocess worker for tests/test_distributed.py.

Trains the SAME tiny configuration on a 2x4 mesh twice — the flagship
sharded on-device-sampling program (replicated device corpus, with
checkpointing) and the data-axis-sharded corpus program — either as one of
``--num_processes`` cooperating OS processes (4 virtual CPU devices each,
gloo collectives) or as a single process owning all 8 devices.  The
primary process saves the fetched final entity table + epoch costs per
mode so the test can compare multi-process against single-process.

Run as a plain script (NOT collected by pytest): it must configure
XLA_FLAGS before jax is imported, which is impossible inside the test
process (tests/conftest.py already initialized an 8-device backend there).
"""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    args = ap.parse_args()

    # Before the first jax import: this process owns 8/num_processes
    # virtual CPU devices (REPLACE any inherited XLA_FLAGS — the parent
    # pytest process forces 8).
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count="
        f"{8 // args.num_processes}"
    )
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.num_processes > 1:
        from cunvsm.parallel.distributed import initialize

        initialize(
            coordinator_address=f"localhost:{args.port}",
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import numpy as np

    from cunvsm.config import (
        AdamConfig,
        AdamMode,
        ModelDesc,
        Nonlinearity,
        TrainConfig,
        UpdateMethod,
    )
    from cunvsm.data.synth import uniform_corpus
    from cunvsm.parallel.distributed import fetch, is_primary
    from cunvsm.parallel.mesh import make_mesh
    from cunvsm.train.trainer import train_model

    desc = ModelDesc(
        word_repr_size=16,
        entity_repr_size=16,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    cfg = TrainConfig(
        num_epochs=2,
        batch_size=16,
        window_size=10,
        num_random_entities=3,
        regularization_lambda=1e-2,
        learning_rate=1e-3,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=7,
    )
    corpus = uniform_corpus(64, 30, 512, window_size=10, seed=3)
    mesh = make_mesh(2, 4)

    for mode, shard_corpus in (("flagship", False), ("shard", True)):
        prefix = None
        if mode == "flagship":
            # Checkpointing exercises the collective snapshot +
            # primary-only write path (io/checkpoint.py).
            prefix = os.path.join(
                args.outdir, f"ckpt_{args.num_processes}p"
            )
        res = train_model(
            desc,
            cfg,
            corpus,
            output_prefix=prefix,
            mesh=mesh,
            on_device_sampling=True,
            shard_corpus=shard_corpus,
            steps_per_call=2,
        )
        ent = fetch(res.params.entity_reprs)
        resumed_ent = None
        if prefix is not None:
            # Resume two more epochs from the epoch-2 state: exercises the
            # sharding-aware restore (load_training_state device_puts onto
            # the like-leaf's NamedSharding) under multi-process.
            import dataclasses

            res2 = train_model(
                desc,
                dataclasses.replace(cfg, num_epochs=4),
                corpus,
                output_prefix=prefix,
                resume=True,
                mesh=mesh,
                on_device_sampling=True,
                shard_corpus=shard_corpus,
                steps_per_call=2,
            )
            assert res2.epoch_costs[-1] < res.epoch_costs[-1]
            resumed_ent = fetch(res2.params.entity_reprs)
        if is_primary():
            out = {"ent": ent, "costs": np.asarray(res.epoch_costs)}
            if resumed_ent is not None:
                out["resumed_ent"] = resumed_ent
            np.savez(
                os.path.join(
                    args.outdir,
                    f"result_{mode}_{args.num_processes}p.npz",
                ),
                **out,
            )
    print("WORKER-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
