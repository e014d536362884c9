#!/usr/bin/env python
"""Reuters-21578 end-to-end visualization (visualize-reuters-collection.sh
rebuild): SGML -> TRECTEXT + classes -> NVSM training -> per-epoch t-SNE
plots of the document embeddings colored by topic.

Requires the Reuters-21578 SGML files locally (the reference downloads them;
this environment has no egress):

    python scripts/visualize_reuters.py --sgm /path/to/*.sgm \
        --workdir /tmp/reuters [--num_epochs 15]

The per-epoch plots land in <workdir>/plots/epoch_<N>.png and are stitched
into <workdir>/training.gif (the visualize-reuters-collection.sh:150
animation) when Pillow is available.
"""

import argparse
import glob
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sgm", nargs="+", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--num_epochs", type=int, default=15)
    p.add_argument("--word_repr_size", type=int, default=300)
    p.add_argument("--entity_repr_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level="INFO")

    from cunvsm.cli._platform import apply_platform

    apply_platform(args)

    from cunvsm.cli import extract_reuters, visualize
    from cunvsm.config import (
        AdamConfig,
        AdamMode,
        DataConfig,
        ModelDesc,
        Nonlinearity,
        TrainConfig,
        UpdateMethod,
    )
    from cunvsm.data.corpus import load_corpus
    from cunvsm.train.trainer import train_model

    os.makedirs(args.workdir, exist_ok=True)
    plots = os.path.join(args.workdir, "plots")
    os.makedirs(plots, exist_ok=True)
    prefix = os.path.join(args.workdir, "reuters")
    classes = os.path.join(args.workdir, "classes.txt")

    sgm_files = []
    for pattern in args.sgm:
        sgm_files.extend(sorted(glob.glob(pattern)))
    rc = extract_reuters.main(
        sgm_files
        + [
            "--trectext_out_prefix", prefix,
            "--document_classification_out", classes,
        ]
    )
    if rc != 0:
        return rc

    window = 10
    data_cfg = DataConfig(
        corpus_path=f"{prefix}_0.trectext",
        max_vocabulary_size=65536,
        min_document_frequency=2,
        max_document_frequency=0.5,
    )
    corpus = load_corpus(data_cfg, window)
    logging.info("Corpus: %d docs, %d terms.", corpus.num_docs, corpus.vocab.size)

    desc = ModelDesc(
        word_repr_size=args.word_repr_size,
        entity_repr_size=args.entity_repr_size,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    cfg = TrainConfig(
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        window_size=window,
        num_random_entities=10,
        learning_rate=1e-3,
        regularization_lambda=1e-2,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        seed=1,
    )
    model_prefix = os.path.join(args.workdir, "model")

    # Quantitative embedding quality alongside the plots: cosine
    # silhouette of the document embeddings against the topic classes
    # (the reference's pipeline only eyeballs the t-SNE,
    # visualize-reuters-collection.sh; a per-epoch score makes the
    # clustering claim measurable).
    import numpy as np

    label_by_docno = {}
    with open(classes) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                label_by_docno[parts[0]] = parts[1]
    labeled_rows = [
        i for i, d in enumerate(corpus.docnos) if d in label_by_docno
    ]
    labels = [label_by_docno[corpus.docnos[i]] for i in labeled_rows]
    silhouette_curve = []

    def class_silhouette(params):
        from sklearn.metrics import silhouette_score

        # sklearn requires 2 <= n_labels <= n_samples - 1.
        n_labels = len(set(labels))
        if not 2 <= n_labels <= len(labels) - 1:
            return None
        emb = np.asarray(params.entity_reprs)[labeled_rows]
        emb = emb / np.maximum(
            np.linalg.norm(emb, axis=1, keepdims=True), 1e-12
        )
        # Subsample: the full score is O(n^2) pairwise distances — at
        # real Reuters scale (10-20k labeled docs) that is GBs and
        # minutes per epoch for a trend line.
        sample = min(len(labels), 2048)
        return float(silhouette_score(
            emb, labels, metric="cosine",
            sample_size=sample if sample < len(labels) else None,
            random_state=0,
        ))

    def plot_epoch(epoch, params, cost):
        s = class_silhouette(params)
        if s is not None:
            silhouette_curve.append((epoch, round(s, 4)))
            logging.info("Epoch %d class silhouette (cosine) = %.4f",
                         epoch, s)
        visualize.main(
            [
                "--model", model_prefix,
                "--epoch", str(epoch),
                "--object_classification", classes,
                "--filter_unclassified",
                "--plot_out", os.path.join(plots, f"epoch_{epoch:03d}.png"),
            ]
        )

    train_model(
        desc,
        cfg,
        corpus,
        output_prefix=model_prefix,
        epoch_callback=plot_epoch,
    )
    logging.info("Plots in %s.", plots)

    import json

    with open(os.path.join(args.workdir, "metrics.json"), "w") as f:
        json.dump({
            "num_labeled_docs": len(labeled_rows),
            "num_classes": len(set(labels)),
            "class_silhouette_cosine_by_epoch": silhouette_curve,
        }, f, indent=2)

    gif = os.path.join(args.workdir, "training.gif")
    if stitch_gif(sorted(glob.glob(os.path.join(plots, "epoch_*.png"))), gif):
        logging.info("Training animation written to %s.", gif)
    return 0


def stitch_gif(frames, out_path, duration_ms=400):
    """Assemble per-epoch plots into an animated GIF
    (visualize-reuters-collection.sh:150 parity, via Pillow instead of
    imagemagick).  Returns False when Pillow or frames are missing."""
    if not frames:
        return False
    try:
        from PIL import Image
    except ImportError:
        logging.warning(
            "Pillow unavailable; stitch %d frames manually "
            "(e.g. convert -delay 40 plots/epoch_*.png training.gif).",
            len(frames),
        )
        return False
    images = [Image.open(f).convert("P", palette=Image.ADAPTIVE)
              for f in frames]
    images[0].save(
        out_path, save_all=True, append_images=images[1:],
        duration=duration_ms, loop=0,
    )
    return True


if __name__ == "__main__":
    sys.exit(main())
