"""cunvsm-combine-runs: QLM+NVSM ensemble fusion (py/combine_runs.py rebuild).

Usage:
    python -m cunvsm.cli.combine_runs --runs a.run b.run \
        --score_normalizer standardize (--alpha 0.5 | --qrel qrels) run_out
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from cunvsm.io.trec import read_qrels, read_run, write_run
from cunvsm.query.fusion import (
    SCORE_NORMALIZERS,
    fuse_cross_validated,
    fuse_fixed_alpha,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loglevel", default="INFO")
    p.add_argument("--qrel", default=None)
    p.add_argument("--num_folds", type=int, default=20)
    p.add_argument("--alpha_stepsize", type=float, default=0.05)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--runs", nargs=2, required=True)
    p.add_argument(
        "--score_normalizer", choices=sorted(SCORE_NORMALIZERS), required=True
    )
    p.add_argument("run_out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.loglevel)

    if (args.qrel is None) == (args.alpha is None):
        print(
            "Specify exactly one of --qrel (supervised) or --alpha "
            "(unsupervised).",
            file=sys.stderr,
        )
        return 1
    if os.path.exists(args.run_out):
        print(f"{args.run_out} already exists.", file=sys.stderr)
        return 1

    run_a = read_run(args.runs[0])
    run_b = read_run(args.runs[1])

    if args.alpha is not None:
        combined = fuse_fixed_alpha(
            run_a, run_b, args.alpha, args.score_normalizer
        )
    else:
        combined = fuse_cross_validated(
            run_a,
            run_b,
            read_qrels(args.qrel),
            num_folds=args.num_folds,
            alpha_stepsize=args.alpha_stepsize,
            normalizer=args.score_normalizer,
        )

    write_run(combined, args.run_out, name="combined")
    logging.info("Run outputted to %s.", args.run_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
