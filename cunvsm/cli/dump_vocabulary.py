"""cunvsm-dump-vocabulary: write a model's in-vocabulary term strings
(py/dump_vocabulary_list.py rebuild; the terms come from the framework's own
vocab sidecar instead of pyndri).

Usage:
    python -m cunvsm.cli.dump_vocabulary --model <prefix> vocabulary_out
"""

from __future__ import annotations

import argparse
import sys

from cunvsm.io.checkpoint import load_strings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("vocabulary_list")
    args = p.parse_args(argv)

    terms = load_strings(f"{args.model}_vocab.txt")
    with open(args.vocabulary_list, "w") as f:
        for t in terms:
            if t:
                f.write(t + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
