"""Reference-RNG replay: the opt-in mode that draws instance order and
negative labels from a bit-exact twin of the CUDA reference's host
minstd_rand0 stream (data/stdrng.py; TrainConfig.reference_rng).

The goldens below were produced by real libstdc++ via
tools/reference_rng_golden.cpp, which mirrors the reference's exact
consumption order on this toy corpus: per-document position draws in
ascending-id order (cpp/data_indri.cpp:328-397), std::shuffle of the
instance pointers (:397), then per-instance negative draws batch by batch
(cpp/labels.cu:3-22), all from one seed-1 stream (main.cu:729-756).
Primitive-level bit validation lives in tests/test_stdrng.py.
"""

import numpy as np
import pytest

from cunvsm.config import DataConfig, ModelDesc, TrainConfig
from cunvsm.data.corpus import build_corpus
from cunvsm.data.instances import TextEntitySource

# Toy corpus: 5 docs, in-vocab lengths 6..10, window 4 -> avg_len 8,
# num_samples ceil(8-4+1)=5, 25 instances, batch 8 -> 3 full batches
# (24 instances; the trailing partial batch is dropped and consumes no
# negative draws, main.cu:392-398).
WINDOW = 4
BATCH = 8
NEG = 3
LENGTHS = [6, 7, 8, 9, 10]

GOLD_LABELS = [3, 0, 1, 3, 4, 4, 1, 4, 0, 1, 2, 0, 2, 2, 3, 4, 3, 2, 1, 2,
               0, 1, 0, 4]
GOLD_POSITIONS = [0, 1, 2, 4, 5, 4, 0, 4, 0, 0, 0, 1, 4, 2, 0, 6, 2, 1, 2,
                  0, 0, 3, 2, 2]
GOLD_NEGATIVES = [3, 4, 1, 1, 4, 3, 3, 3, 0, 3, 4, 1, 2, 3, 2, 1, 1, 1, 0,
                  2, 4, 4, 0, 4, 2, 2, 1, 4, 2, 1, 0, 4, 0, 2, 1, 1, 4, 2,
                  2, 4, 0, 3, 3, 4, 0, 0, 3, 4, 3, 3, 3, 4, 4, 1, 1, 1, 2,
                  2, 4, 2, 4, 1, 2, 2, 2, 1, 0, 0, 2, 4, 0, 2]


def toy_corpus():
    # Unique token per (doc, offset) so the window position is recoverable
    # from the first feature's term string.
    docs = [
        (f"doc{d}", " ".join(f"w{d}x{j}" for j in range(n)))
        for d, n in enumerate(LENGTHS)
    ]
    return build_corpus(
        docs,
        DataConfig(max_vocabulary_size=0, min_document_frequency=0,
                   max_document_frequency=0),
        window_size=WINDOW,
    )


def make_source(**kw):
    return TextEntitySource(
        toy_corpus(), batch_size=BATCH, shuffle=True, seed=1,
        reference_rng=True, num_negative=NEG, **kw,
    )


def test_label_stream_matches_reference_for_seed_1():
    corpus = toy_corpus()
    src = make_source()
    assert src._samples_per_doc == 5
    labels, negatives, positions = [], [], []
    id_to_term = corpus.vocab.terms
    for batch in src.epoch_batches():
        labels.extend(int(x) for x in batch.labels)
        assert batch.negatives is not None and batch.negatives.shape == (
            BATCH, NEG,
        )
        negatives.extend(int(x) for x in batch.negatives.ravel())
        for row in batch.features:
            positions.append(int(id_to_term[int(row[0])].split("x")[1]))
    assert labels == GOLD_LABELS
    assert positions == GOLD_POSITIONS
    assert negatives == GOLD_NEGATIVES


# Glorot init interleaved into the same seed-1 stream (the full trainer
# protocol): epoch-1 reset draws, then init_matrix_glorot for words
# (d_w=3 x V=40), entities (d_e=2 x D=5), transform (2 x 3) in
# ModelBase::initialize order (model.cu:37-43), then the first-epoch
# negatives.  f32 bit patterns produced by real libstdc++/g++ via
# tools/reference_init_golden.cpp.
GOLD_INIT_D_W, GOLD_INIT_D_E = 3, 2
GOLD_WORD_BITS_HEAD = [1044654227, 1052496762, 3184396633, 3191964937,
                       1052284006, 1042962128, 1044501080, 1038603303]
GOLD_WORD_BITS_TAIL = [3194335460, 3188344564, 1036372303, 3197028654]
GOLD_ENTITY_BITS = [1049584899, 1046913205, 1057991074, 3203337817,
                    3174219685, 3193036416, 3205278286, 3210710847,
                    1061054135, 3188415973]
GOLD_TRANSFORM_BITS = [3209217895, 1065024289, 3192468941, 3209616066,
                       1062751293, 3211050138]
GOLD_NEGATIVES_AFTER_INIT_HEAD = [0, 0, 1, 1, 0, 3, 2, 1]
GOLD_NEGATIVES_AFTER_INIT_TAIL = [2, 2, 4, 1]


def _f32_bits(arr):
    import struct

    flat = np.asarray(arr, np.float32).reshape(-1)
    return [
        struct.unpack("<I", struct.pack("<f", float(v)))[0] for v in flat
    ]


def test_glorot_init_matches_reference_for_seed_1():
    """The full replay protocol is bit-exact against real libstdc++: epoch-1
    reset draws (draw_next_epoch), Glorot init (reference_init_params), then
    the label stream continues from the post-init stream position."""
    from cunvsm.config import ModelDesc
    from cunvsm.models.params import reference_init_params

    corpus = toy_corpus()
    src = make_source()
    src.draw_next_epoch()  # the generator-ctor reset (data_indri.cpp:279)
    desc = ModelDesc(
        word_repr_size=GOLD_INIT_D_W, entity_repr_size=GOLD_INIT_D_E
    )
    params = reference_init_params(
        src.std_rng, corpus.vocab.size, corpus.num_docs, desc
    )
    word_bits = _f32_bits(params.word_reprs)
    assert word_bits[:8] == GOLD_WORD_BITS_HEAD
    assert word_bits[-4:] == GOLD_WORD_BITS_TAIL
    assert _f32_bits(params.entity_reprs) == GOLD_ENTITY_BITS
    assert _f32_bits(params.transform_w) == GOLD_TRANSFORM_BITS
    assert np.all(np.asarray(params.transform_b) == 0.0)

    negatives = []
    for batch in src.epoch_batches():
        negatives.extend(int(x) for x in batch.negatives.ravel())
    assert negatives[:8] == GOLD_NEGATIVES_AFTER_INIT_HEAD
    assert negatives[-4:] == GOLD_NEGATIVES_AFTER_INIT_TAIL
    # The instance order itself is unaffected by where init draws land
    # (reset draws all precede init).
    assert len(negatives) == len(GOLD_NEGATIVES)


def test_glorot_init_full_differential_against_live_gplusplus(tmp_path):
    """Compile tools/reference_init_golden.cpp with the live g++ and compare
    every word/entity/transform bit and the post-init negative stream."""
    import re
    import shutil
    import subprocess

    if not shutil.which("g++"):
        pytest.skip("g++ not available")
    exe = str(tmp_path / "refinit")
    subprocess.run(
        ["g++", "-O2", "-std=c++14", "-o", exe,
         "tools/reference_init_golden.cpp"],
        check=True, cwd="/root/repo",
    )
    txt = subprocess.run([exe], capture_output=True, text=True).stdout

    def arr(name):
        return [int(x) for x in
                re.search(name + r" = \[([^\]]*)\]", txt).group(1).split(",")]

    from cunvsm.config import ModelDesc
    from cunvsm.models.params import reference_init_params

    corpus = toy_corpus()
    src = make_source()
    src.draw_next_epoch()
    desc = ModelDesc(
        word_repr_size=GOLD_INIT_D_W, entity_repr_size=GOLD_INIT_D_E
    )
    params = reference_init_params(
        src.std_rng, corpus.vocab.size, corpus.num_docs, desc
    )
    assert _f32_bits(params.word_reprs) == arr("word_bits")
    assert _f32_bits(params.entity_reprs) == arr("entity_bits")
    assert _f32_bits(params.transform_w) == arr("transform_bits")
    negatives = []
    for batch in src.epoch_batches():
        negatives.extend(int(x) for x in batch.negatives.ravel())
    assert negatives == arr("negatives")


def test_trainer_uses_reference_init():
    """train_model under reference_rng initializes from the shared stream
    (epoch-1 reset draws first, Glorot second): with num_epochs=0 the
    returned params ARE the init and must match the pinned g++ bits."""
    from cunvsm.train.trainer import train_model

    corpus = toy_corpus()
    desc = ModelDesc(
        word_repr_size=GOLD_INIT_D_W, entity_repr_size=GOLD_INIT_D_E
    )
    cfg = TrainConfig(
        num_epochs=0, batch_size=BATCH, window_size=WINDOW,
        num_random_entities=NEG, reference_rng=True, seed=1,
    )
    res = train_model(desc, cfg, corpus)
    word_bits = _f32_bits(res.params.word_reprs)
    assert word_bits[:8] == GOLD_WORD_BITS_HEAD
    assert word_bits[-4:] == GOLD_WORD_BITS_TAIL
    assert _f32_bits(res.params.entity_reprs) == GOLD_ENTITY_BITS
    assert _f32_bits(res.params.transform_w) == GOLD_TRANSFORM_BITS


def test_second_epoch_continues_the_stream():
    """Epoch 2's draws continue the shared stream (the reference reuses the
    same RNG across resets) — they must differ from epoch 1 and be
    reproducible."""
    src1, src2 = make_source(), make_source()
    e1 = [b.labels.tolist() for b in src1.epoch_batches()]
    e2 = [b.labels.tolist() for b in src1.epoch_batches()]
    assert e1 != e2
    assert [b.labels.tolist() for b in src2.epoch_batches()] == e1
    assert [b.labels.tolist() for b in src2.epoch_batches()] == e2


def test_skip_epochs_replays_negative_draws():
    """Resume parity: skip_epochs(1) must leave the stream exactly where a
    consumed epoch 1 leaves it, including the negative draws."""
    consumed, skipped = make_source(), make_source()
    for _ in consumed.epoch_batches():
        pass
    skipped.skip_epochs(1)
    assert consumed._std_rng.state == skipped._std_rng.state
    e2a = [b.labels.tolist() for b in consumed.epoch_batches()]
    e2b = [b.labels.tolist() for b in skipped.epoch_batches()]
    assert e2a == e2b


def test_training_consumes_host_negatives():
    """End-to-end: a training step with reference_rng uses the batch's
    host-drawn negatives (step.py feeds them into the NCE objective), and
    the run is bit-reproducible."""
    import jax

    from cunvsm.train.trainer import train_model

    corpus = toy_corpus()
    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    cfg = TrainConfig(
        num_epochs=2, batch_size=BATCH, window_size=WINDOW,
        num_random_entities=NEG, learning_rate=0.01, reference_rng=True,
    )
    r1 = train_model(desc, cfg, corpus)
    r2 = train_model(desc, cfg, corpus)
    assert r1.epoch_costs == r2.epoch_costs
    np.testing.assert_array_equal(
        np.asarray(r1.params.word_reprs), np.asarray(r2.params.word_reprs)
    )


def test_reference_rng_guards():
    from cunvsm.train.step import resolve_negative_sampling

    desc = ModelDesc(word_repr_size=4, entity_repr_size=4)
    cfg = TrainConfig(
        batch_size=BATCH, num_random_entities=NEG, reference_rng=True,
        negative_pool_size=64,
    )
    with pytest.raises(ValueError, match="reference_rng"):
        resolve_negative_sampling(cfg, desc, BATCH)
    # AUTO (-1) resolves to per-instance under reference_rng.
    cfg2 = TrainConfig(
        batch_size=BATCH, num_random_entities=NEG, reference_rng=True,
    )
    assert resolve_negative_sampling(cfg2, desc, BATCH) == (0, 1)

    from cunvsm.train.trainer import train_model

    cfg3 = TrainConfig(
        num_epochs=1, batch_size=BATCH, window_size=WINDOW,
        num_random_entities=NEG, learning_rate=0.01, reference_rng=True,
    )
    with pytest.raises(ValueError, match="on_device_sampling"):
        train_model(desc, cfg3, toy_corpus(), on_device_sampling=True)


def test_skip_epochs_after_draw_next_epoch():
    """Resume under the full protocol: a source whose first epoch was
    pre-drawn (the Glorot ordering hook) must skip to the same stream
    position a consumed run reaches."""
    consumed, skipped = make_source(), make_source()
    for src in (consumed, skipped):
        src.draw_next_epoch()
    for _ in consumed.epoch_batches():
        pass
    for _ in consumed.epoch_batches():  # epoch 2
        pass
    skipped.skip_epochs(2)
    assert consumed._std_rng.state == skipped._std_rng.state
    e3a = [b.labels.tolist() for b in consumed.epoch_batches()]
    e3b = [b.labels.tolist() for b in skipped.epoch_batches()]
    assert e3a == e3b
