"""cunvsm-visualize: t-SNE plots / embedding-projector export of document
embeddings (py/visualize.py rebuild).

Modes:
  * ``tsne``: 2-D t-SNE of the entity (document) embeddings, colored by the
    classes in --object_classification, written to --plot_out;
  * ``embedding_projector``: tensors.tsv + metadata.tsv for the TensorFlow
    embedding projector.

Usage:
    python -m cunvsm.cli.visualize --model <prefix> --epoch N \
        --object_classification classes.txt --plot_out plot.png
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loglevel", default="INFO")
    from cunvsm.cli._platform import add_platform_flag

    add_platform_flag(p)
    p.add_argument("--model", required=True)
    p.add_argument("--epoch", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--object_classification", default=None)
    p.add_argument("--filter_unclassified", action="store_true")
    p.add_argument("--l2_normalize", action="store_true")
    p.add_argument(
        "--mode", choices=["tsne", "embedding_projector"], default="tsne"
    )
    p.add_argument("--legend", action="store_true")
    p.add_argument("--border", action="store_true")
    p.add_argument("--perplexity", type=float, default=30.0)
    p.add_argument("--plot_out", required=True)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cunvsm.cli._platform import apply_platform

    apply_platform(args)
    logging.basicConfig(level=args.loglevel)

    from cunvsm.io import checkpoint as ckpt

    params = ckpt.load_model_hdf5(args.model, args.epoch)
    docnos = ckpt.load_strings(f"{args.model}_docnos.txt")
    reprs = np.asarray(params.entity_reprs)

    classes = {}
    if args.object_classification:
        with open(args.object_classification) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    classes[parts[0]] = parts[1]

    keep = np.arange(len(docnos))
    if args.filter_unclassified and classes:
        keep = np.asarray(
            [i for i, d in enumerate(docnos) if d in classes], dtype=np.int64
        )
    if args.limit:
        keep = keep[: args.limit]
    reprs = reprs[keep]
    kept_docnos = [docnos[i] for i in keep]
    labels = [classes.get(d, "?") for d in kept_docnos]

    if args.l2_normalize:
        reprs = reprs / np.maximum(
            np.linalg.norm(reprs, axis=1, keepdims=True), 1e-30
        )

    if args.mode == "embedding_projector":
        with open(args.plot_out + "_tensors.tsv", "w") as f:
            for row in reprs:
                f.write("\t".join(f"{v:.6f}" for v in row) + "\n")
        with open(args.plot_out + "_metadata.tsv", "w") as f:
            f.write("docno\tclass\n")
            for d, c in zip(kept_docnos, labels):
                f.write(f"{d}\t{c}\n")
        logging.info("Projector files written to %s_*.tsv", args.plot_out)
        return 0

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    perplexity = min(args.perplexity, max(2.0, (len(reprs) - 1) / 3.0))
    xy = TSNE(
        n_components=2, random_state=0, perplexity=perplexity, init="pca"
    ).fit_transform(reprs)

    fig, ax = plt.subplots(figsize=(8, 8))
    unique = sorted(set(labels))
    cmap = plt.get_cmap("tab20")
    for i, cls in enumerate(unique):
        mask = np.asarray([l == cls for l in labels])
        ax.scatter(
            xy[mask, 0],
            xy[mask, 1],
            s=8,
            color=cmap(i % 20),
            label=cls,
            edgecolors="k" if args.border else "none",
            linewidths=0.2,
        )
    if args.legend:
        ax.legend(markerscale=2, fontsize=7, loc="best")
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(args.plot_out, dpi=150)
    logging.info("Plot written to %s.", args.plot_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
