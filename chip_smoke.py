"""Smoke test of the training and query path on an NVIDIA GPU.

Drives the NVSM preset (hard_tanh + batch norm + full_adam; word 300,
entity 256, window 10, 10 negatives, batch 51200) through the entry points a
user calls, and checks each phase against a plain reference:

  (a) device: the card, its power limit, JAX's view of it;
  (b) train: ``train_model`` with on-device sampling over a 262,144-document
      Zipf corpus (bf16 streams, pooled negatives), then the host-fed
      reference-exact path (f32, per-instance negatives);
  (c) reference: K ``make_train_step`` steps on the card against the same
      steps on the host CPU in f32, and bf16 streams against the card's own
      f32 run at full matmul precision;
  (d) optimizer: the full_adam update against a float64 numpy closed form;
  (e) query: ``QueryEngine.rank`` top-1000 (f32 and bf16 scoring) against a
      float64 brute force;
  (f) checkpoint: ``cunvsm-train --output`` then ``cunvsm-query`` on the
      written checkpoint (needs h5py and protobuf; reported as not run
      without them).

With ``--four-cards`` only the 2x2 ("data", "model") mesh path runs: sharded
steps against one card, the device-sampled and corpus-sharded multisteps
with the collective budget checked on their compiled HLO, and sharded top-k
against single-card top-k.

Every phase prints one or more lines; the last line of standard output is
``{"ok": true, "device": {...}}``.  Without a GPU, or when any phase fails,
the script exits non-zero and prints no such line.

    python chip_smoke.py                # one card, phases (a)-(f)
    python chip_smoke.py --four-cards   # four cards, the mesh path only
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of every phase.  The defaults are the NVSM preset's published
    widths (functions.sh:263-271,369-400); tests shrink them."""

    num_words: int = 65536
    word_dim: int = 300
    entity_dim: int = 256
    batch: int = 51200
    window: int = 10
    negatives: int = 10
    train_docs: int = 262144
    doc_len: int = 32
    train_epochs: int = 2
    host_docs: int = 8192
    # Entity count of the CPU comparison, cut so the CPU side of phase (c)
    # stays under a minute; widths, batch, window and k stay canonical.
    ref_entities: int = 16384
    ref_steps: int = 3
    sweep_rows: int = 262144
    num_queries: int = 64
    query_len: int = 4
    top_k: int = 1000
    cli_docs: int = 64
    cli_batch: int = 256


# Tolerances of phase (c) and the mesh comparison, as relative L2 errors:
# of the K costs, of the Adam moments, and of each table's update (final
# minus initial).  Each bound is about 10x the error the first H100 run
# showed, and below what a wrong gradient of any one term would cause.
TOL = {
    # f32 at "highest" on both sides: only the summation order differs
    # (scatter atomics, reduction trees, collectives).  Seen: 8e-6.
    "f32_highest": {"cost": 1e-6, "moment": 1e-4, "update": 1e-4},
    # The program's own precision against host f32: f32 dots may run in
    # TF32 on the card (10 explicit mantissa bits, ~5e-4 relative per
    # product), averaged over long sums.  Seen: 6e-4.
    "f32_default": {"cost": 1e-5, "moment": 5e-3, "update": 5e-3},
    # bf16 streams and window sums (8 mantissa bits, ~4e-3 per element)
    # against the card's f32 run at "highest".  Seen: 6e-3.
    "bf16": {"cost": 1e-4, "moment": 5e-2, "update": 5e-2},
}
# Cosine-score error bounds of phase (e): both operands are unit vectors, so
# the absolute error is at most the relative rounding of one product:
# 2^-10 under TF32 (plus the projection's), 2^-8 under bf16.
QUERY_TOL = {"float32": 3e-3, "bfloat16": 1e-2}


def nvsm_preset(s: Sizes, **overrides):
    """(ModelDesc, TrainConfig) of the NVSM preset at the sizes ``s``."""
    from cunvsm.config import (
        AdamConfig,
        AdamMode,
        ModelDesc,
        Nonlinearity,
        TrainConfig,
        UpdateMethod,
    )

    desc = ModelDesc(
        word_repr_size=s.word_dim,
        entity_repr_size=s.entity_dim,
        nonlinearity=Nonlinearity.HARD_TANH,
        batch_normalization=True,
    )
    cfg = TrainConfig(
        batch_size=s.batch,
        window_size=s.window,
        num_random_entities=s.negatives,
        update_method=UpdateMethod.ADAM,
        adam=AdamConfig(mode=AdamMode.DENSE_UPDATE_DENSE_VARIANCE),
        learning_rate=1e-3,
        regularization_lambda=1e-2,
        seed=1,
    )
    return desc, dataclasses.replace(cfg, **overrides)


def zipf_ids(rng, shape, vocab_size, exponent=1.07):
    """Zipf-distributed word ids, as data/synth.zipf_corpus draws them."""
    p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** exponent
    cdf = np.cumsum(p / p.sum())
    draws = np.searchsorted(cdf, rng.random_sample(int(np.prod(shape))))
    return np.minimum(draws, vocab_size - 1).astype(np.int32).reshape(shape)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_abs(a, b) -> float:
    return float(
        np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
    )


class PhaseError(AssertionError):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


# ---------------------------------------------------------------------------
# (a) Device.
# ---------------------------------------------------------------------------


def phase_device(expected_count: int):
    import jax

    from cunvsm.cli._platform import device_record

    devices = jax.devices()
    _check(
        devices[0].platform == "gpu",
        f"no GPU: JAX's first device is {devices[0].platform}",
    )
    _check(
        len(devices) >= expected_count,
        f"need {expected_count} cards, JAX sees {len(devices)}",
    )
    # The card's name and power limit, exactly as nvidia-smi prints them.
    print(device_record()["card"])
    stats = devices[0].memory_stats() or {}
    print(
        f"[a] jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}"
        f", bytes_limit={stats.get('bytes_limit')}"
    )


# ---------------------------------------------------------------------------
# (b) Train through train_model.
# ---------------------------------------------------------------------------


def phase_train(s: Sizes):
    """Returns the trained params of the on-device-sampling run."""
    from cunvsm.data.synth import zipf_corpus
    from cunvsm.train.trainer import train_model

    corpus = zipf_corpus(
        s.train_docs, s.doc_len, s.num_words, window_size=s.window, seed=1
    )
    desc, cfg = nvsm_preset(
        s, num_epochs=s.train_epochs, stream_dtype="bfloat16",
        window_sum_dtype="bfloat16",
    )
    start = time.perf_counter()
    res = train_model(desc, cfg, corpus, on_device_sampling=True)
    secs = time.perf_counter() - start
    costs = res.epoch_costs
    print(
        f"[b] on-device sampling, {s.train_docs} docs, bf16 streams, pooled "
        f"negatives: epoch costs {costs} ({secs:.1f} s incl. compile)"
    )
    _check(len(costs) == s.train_epochs, f"epochs run: {len(costs)}")
    _check(bool(np.all(np.isfinite(costs))), f"non-finite costs {costs}")
    _check(costs[-1] < costs[0], f"epoch cost did not fall: {costs}")

    host = zipf_corpus(
        s.host_docs, s.doc_len, s.num_words, window_size=s.window, seed=2
    )
    desc_h, cfg_h = nvsm_preset(s, num_epochs=2, negative_pool_size=0)
    res_h = train_model(desc_h, cfg_h, host)
    print(
        f"[b] host-fed, {s.host_docs} docs, f32, per-instance negatives: "
        f"epoch costs {res_h.epoch_costs}"
    )
    _check(
        bool(np.all(np.isfinite(res_h.epoch_costs))),
        f"non-finite costs {res_h.epoch_costs}",
    )
    _check(
        res_h.epoch_costs[-1] < res_h.epoch_costs[0],
        f"epoch cost did not fall: {res_h.epoch_costs}",
    )
    return res.params


# ---------------------------------------------------------------------------
# (c) K steps on the card against the host CPU.
# ---------------------------------------------------------------------------


def reference_inputs(s: Sizes, num_entities: int, desc, cfg, seed: int = 3):
    """Host copies of initial params, optimizer state, K batches, K keys."""
    import jax

    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import init_params
    from cunvsm.optim.updates import Optimizer

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        params = jax.device_get(
            init_params(
                jax.random.PRNGKey(seed), s.num_words, num_entities, desc
            )
        )
        opt_state = jax.device_get(Optimizer(cfg).init(params))
        keys = [
            np.asarray(jax.random.PRNGKey(100 + i))
            for i in range(s.ref_steps)
        ]
    rng = np.random.RandomState(seed)
    batches = [
        TextEntityBatch(
            features=zipf_ids(rng, (s.batch, s.window), s.num_words),
            feature_weights=np.ones((s.batch, s.window), np.float32),
            labels=rng.randint(0, num_entities, s.batch).astype(np.int32),
            weights=np.ones((s.batch,), np.float32),
        )
        for _ in range(s.ref_steps)
    ]
    return params, opt_state, batches, keys


def run_steps(step, params, opt_state, batches, keys, device,
              precision=None):
    """Run ``step`` over the batches on ``device``; host copies back."""
    import jax

    put = lambda tree: jax.device_put(tree, device)  # noqa: E731
    ctx = (
        jax.default_matmul_precision(precision)
        if precision else contextlib.nullcontext()
    )
    p, o = put(params), put(opt_state)
    costs = []
    with ctx:
        for b, k in zip(batches, keys):
            p, o, c = step(p, o, put(b), put(k))
            costs.append(c)
    return np.asarray(jax.device_get(costs)), jax.device_get((p, o))


def compare_runs(label, run, ref, params0, tol) -> dict:
    """Print and check costs, the four tables' updates and the Adam
    moments of ``run`` against ``ref``; returns the worst errors."""
    costs, (p, o) = run
    ref_costs, (rp, ro) = ref
    cost_rel = float(np.max(
        np.abs(costs - ref_costs) / np.maximum(np.abs(ref_costs), 1e-30)
    ))
    rows = [("cost", cost_rel, None, tol["cost"])]
    for name in ("word_reprs", "entity_reprs", "transform_w", "transform_b"):
        p0 = np.asarray(getattr(params0, name), np.float64)
        a = np.asarray(getattr(p, name), np.float64)
        b = np.asarray(getattr(rp, name), np.float64)
        rows.append(
            (f"{name} update", _rel(a - p0, b - p0), _max_abs(a, b),
             tol["update"])
        )
    for part in ("word", "entity", "transform"):
        mine, theirs = getattr(o, part), getattr(ro, part)
        for field in mine._fields:
            if field != "t":
                a, b = getattr(mine, field), getattr(theirs, field)
                rows.append((f"{part}.{field}", _rel(a, b), _max_abs(a, b),
                             tol["moment"]))
    print(f"[c] {label}: costs {costs.tolist()} vs {ref_costs.tolist()}")
    failed = []
    for name, rel, max_abs, bound in rows:
        extra = "" if max_abs is None else f" max_abs={max_abs:.3e}"
        print(f"[c]   {name}: rel={rel:.3e}{extra} (tol {bound:g})")
        if not rel <= bound:
            failed.append(f"{name} rel {rel:.3e} > {bound:g}")
    _check(not failed, f"{label}: " + "; ".join(failed))
    return {name: rel for name, rel, _, _ in rows}


def phase_reference(s: Sizes, tol=TOL):
    import jax

    from cunvsm.train.step import make_train_step

    card = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    desc, cfg32 = nvsm_preset(s, uniform_feature_weights=True)
    _, cfg16 = nvsm_preset(
        s, uniform_feature_weights=True, stream_dtype="bfloat16",
        window_sum_dtype="bfloat16",
    )
    params, opt_state, batches, keys = reference_inputs(
        s, s.ref_entities, desc, cfg32
    )

    def run(cfg, device, precision=None):
        step = make_train_step(desc, cfg)
        return run_steps(
            step, params, opt_state, batches, keys, device, precision
        )

    host = run(cfg32, cpu)
    f32_default = run(cfg32, card)
    f32_highest = run(cfg32, card, "highest")
    bf16 = run(cfg16, card)
    compare_runs(
        f"card f32 at 'highest' vs host f32 ({s.ref_steps} steps, "
        f"{s.ref_entities} entities)",
        f32_highest, host, params, tol["f32_highest"],
    )
    moved = compare_runs(
        "card f32 at the default matmul precision vs host f32",
        f32_default, host, params, tol["f32_default"],
    )
    print(
        f"[c] default matmul precision (TF32 allowed) moves the cost by "
        f"{moved['cost']:.3e} relative"
    )
    compare_runs(
        "card bf16 streams vs card f32 at 'highest'",
        bf16, f32_highest, params, tol["bf16"],
    )


# ---------------------------------------------------------------------------
# (d) The full_adam update against float64.
# ---------------------------------------------------------------------------


def adam_full_reference(table, m, v, idx, grad, t, lr, lam, beta1, beta2,
                        eps):
    """float64 closed form of the full_adam update (updates_adam.cu:
    203-213,253-282,312-328): scatter, L2 folded into the moments, dense
    bias-corrected step."""
    scattered = np.zeros(table.shape, np.float64)
    np.add.at(scattered, idx, np.asarray(grad, np.float64))
    table = np.asarray(table, np.float64)
    agg = scattered - lam * table
    m = beta1 * np.asarray(m, np.float64) + (1.0 - beta1) * agg
    v = beta2 * np.asarray(v, np.float64) + (1.0 - beta2) * agg * agg
    bc = np.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    return m, v, table + lr * bc * m / (np.sqrt(v) + eps)


def phase_sweep(s: Sizes, iters: int = 20):
    import jax

    from cunvsm.models.objectives import SparseGrad
    from cunvsm.optim.updates import ReprAdamState, _repr_adam_full

    rows, dim, n = s.sweep_rows, s.entity_dim, s.batch
    rng = np.random.RandomState(7)
    table = (0.05 * rng.randn(rows, dim)).astype(np.float32)
    m = (1e-3 * rng.randn(rows, dim)).astype(np.float32)
    v = (1e-6 * np.abs(rng.randn(rows, dim))).astype(np.float32)
    idx = rng.randint(0, rows, (n, 1)).astype(np.int32)
    grad = (1e-2 * rng.randn(n, dim)).astype(np.float32)
    t, lr, lam, beta1, beta2, eps = 3, 1e-3, 1e-2 / n, 0.9, 0.999, 1e-6

    @jax.jit
    def update(state, table, grad, idx):
        state, table = _repr_adam_full(
            state, table, (SparseGrad(grad, idx, None),),
            lr, lam, beta1, beta2, eps,
        )
        return state.m, state.v, table

    state = ReprAdamState(m, v, np.asarray(t, np.int32))
    out = jax.device_get(update(state, table, grad, idx))
    ref = adam_full_reference(
        table, m, v, idx[:, 0], grad, t, lr, lam, beta1, beta2, eps
    )
    # f32 against float64: a few ulps per operation, amplified in the table
    # by m / (sqrt(v) + eps) where v is near eps^2 (the update then reaches
    # 0.2 for |table| <= 0.3).  Seen on the CPU and the H100: 5e-8 (m, v),
    # 4e-6 (update), 9e-7 (table max-abs).
    upd, ref_upd = out[2] - table, ref[2] - table
    errs = {
        "m rel": (_rel(out[0], ref[0]), 1e-6),
        "v rel": (_rel(out[1], ref[1]), 1e-6),
        "table update rel": (_rel(upd, ref_upd), 1e-4),
        "table max_abs": (_max_abs(out[2], ref[2]), 1e-5),
    }
    dev = [jax.device_put(x) for x in (state, table, grad, idx)]
    jax.block_until_ready(update(*dev))
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        jax.block_until_ready(update(*dev))
        times.append(time.perf_counter() - start)
    median = float(np.median(times))
    sweep_bytes = 7 * rows * dim * 4
    print(
        f"[d] full_adam update {rows}x{dim} f32 ({n} scattered rows): median "
        f"{median * 1e3:.3f} ms; sweep bytes 7*R*d*4 = {sweep_bytes / 1e9:.3f}"
        f" GB -> {sweep_bytes / median / 1e9:.1f} GB/s (scatter included)"
    )
    for name, (err, bound) in errs.items():
        print(f"[d]   {name} vs float64: {err:.3e} (tol {bound:g})")
    _check(
        all(err <= bound for err, bound in errs.values()),
        f"full_adam update vs float64: {errs}",
    )


# ---------------------------------------------------------------------------
# (e) Query top-k against a float64 brute force.
# ---------------------------------------------------------------------------


def check_topk(ids, scores, ref_scores, k, tol):
    """Returns (score_err, overlap).  Outside a band of 2*tol around the
    reference's k-th score both sets must agree exactly."""
    score_err = float(np.max(np.abs(scores - ref_scores[ids])))
    ref_top = np.argpartition(-ref_scores, k - 1)[:k]
    kth = float(np.min(ref_scores[ref_top]))
    sure_in = set(np.flatnonzero(ref_scores > kth + 2 * tol).tolist())
    got = set(int(i) for i in ids)
    _check(sure_in <= got, f"missed {len(sure_in - got)} clear top-k docs")
    _check(
        bool(np.all(ref_scores[ids] >= kth - 2 * tol)),
        "returned a doc clearly outside the top-k",
    )
    return score_err, len(got & set(ref_top.tolist())) / k


def phase_query(s: Sizes, params):
    import jax.numpy as jnp

    from cunvsm.query.engine import QueryEngine

    num_docs = params.entity_reprs.shape[0]
    terms = [f"t{i}" for i in range(s.num_words)]
    docnos = [f"d{i}" for i in range(num_docs)]
    rng = np.random.RandomState(11)
    q_ids = zipf_ids(rng, (s.num_queries, s.query_len), s.num_words)
    queries = {
        f"q{i}": [terms[j] for j in row] for i, row in enumerate(q_ids)
    }
    word = np.asarray(params.word_reprs, np.float64)
    w = np.asarray(params.transform_w, np.float64)
    proj = word[q_ids].mean(axis=1) @ w
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    ent = np.asarray(params.entity_reprs, np.float64)
    ent /= np.maximum(np.linalg.norm(ent, axis=1, keepdims=True), 1e-30)
    ref = proj @ ent.T  # [Q, D] float64 cosine scores
    k = min(s.top_k, num_docs)
    for name, dtype in (("float32", None), ("bfloat16", jnp.bfloat16)):
        engine = QueryEngine(
            params, terms, docnos, nonlinearity=None, score_dtype=dtype
        )
        engine.rank(queries, top_k=k)  # compile
        start = time.perf_counter()
        run = engine.rank(queries, top_k=k)
        secs = time.perf_counter() - start
        tol = QUERY_TOL[name]
        errs, overlaps = [], []
        for i in range(s.num_queries):
            ranked = run[f"q{i}"]
            ids = np.asarray([int(d[1:]) for d, _ in ranked])
            scores = np.asarray([sc for _, sc in ranked], np.float64)
            err, overlap = check_topk(ids, scores, ref[i], k, tol)
            errs.append(err)
            overlaps.append(overlap)
        print(
            f"[e] rank {s.num_queries} queries, top-{k} of {num_docs} docs, "
            f"{name} scores: {secs * 1e3:.2f} ms; max score err "
            f"{max(errs):.3e} (tol {tol:g}); min top-k overlap "
            f"{min(overlaps):.4f} (sets agree outside the 2*tol band)"
        )
        _check(max(errs) <= tol, f"{name} score error {max(errs):.3e}")


# ---------------------------------------------------------------------------
# (f) Checkpoint round trip through the CLIs.
# ---------------------------------------------------------------------------


def phase_checkpoint(s: Sizes, workdir: str) -> bool:
    """Returns False when h5py or protobuf is missing (phase not run)."""
    try:
        import google.protobuf  # noqa: F401
        import h5py  # noqa: F401
    except ImportError as exc:
        print(f"[f] checkpoint round trip: NOT RUN ({exc})")
        return False
    from cunvsm.cli import query as cli_query
    from cunvsm.cli import train as cli_train
    from cunvsm.io.checkpoint import load_model_hdf5
    from cunvsm.io.trec import read_run

    rng = np.random.RandomState(0)
    topics = {
        "space": "rocket orbit launch satellite astronaut".split(),
        "food": "recipe oven flour butter bake".split(),
    }
    corpus = os.path.join(workdir, "docs.trectext")
    with open(corpus, "w") as f:
        for i in range(s.cli_docs):
            name = sorted(topics)[i % 2]
            words = topics[name]
            body = " ".join(words[j] for j in rng.randint(len(words), size=40))
            f.write(
                f"<DOC>\n<DOCNO>{name}_{i}</DOCNO>\n<TEXT>\n{body}\n"
                "</TEXT>\n</DOC>\n"
            )
    prefix = os.path.join(workdir, "model")
    rc = cli_train.main([
        corpus, "--output", prefix, "--num_epochs", "2",
        "--batch_size", str(s.cli_batch), "--window_size", str(s.window),
        "--num_random_entities", str(s.negatives),
        "--word_repr_size", str(s.word_dim),
        "--entity_repr_size", str(s.entity_dim),
        "--update_method", "full_adam", "--nonlinearity", "hard_tanh",
        "--batch_normalization", "--seed", "1",
        "--max_vocabulary_size", "0", "--min_document_frequency", "0",
        "--max_document_frequency", "0", "--loglevel", "WARNING",
    ])
    _check(rc == 0, f"cunvsm-train exited {rc}")
    params = load_model_hdf5(prefix, 2)
    _check(
        params.entity_reprs.shape == (s.cli_docs, s.entity_dim)
        and params.word_reprs.shape[1] == s.word_dim,
        f"checkpoint shapes {params.entity_reprs.shape}",
    )
    topics_file = os.path.join(workdir, "topics.txt")
    with open(topics_file, "w") as f:
        f.write("1;rocket orbit\n2;oven bake\n")
    run_file = os.path.join(workdir, "out.run")
    rc = cli_query.main([
        "--topics", topics_file, "--model", prefix, "--epoch", "2",
        "--linear", "--loglevel", "WARNING", run_file,
    ])
    _check(rc == 0, f"cunvsm-query exited {rc}")
    run = read_run(run_file)
    _check(sorted(run) == ["1", "2"], f"run holds queries {sorted(run)}")
    scores = [sc for ranked in run.values() for _, sc in ranked]
    _check(
        all(len(r) == s.cli_docs for r in run.values())
        and bool(np.all(np.isfinite(scores))),
        "run lacks documents or holds non-finite scores",
    )
    print(
        f"[f] cunvsm-train --output ({s.cli_docs} docs, 2 epochs) -> HDF5 + "
        f"meta -> cunvsm-query: {len(run)} rankings of {s.cli_docs} docs"
    )
    return True


# ---------------------------------------------------------------------------
# --four-cards: the 2x2 mesh.
# ---------------------------------------------------------------------------


def _audit_collectives(hlo, batch, window, word_table_bytes, label):
    """The collective budget of the sharded programs: the word-gradient
    stream never crosses the interconnect as a stream, and the largest
    collective is the [V, d_w] word-table psum."""
    from cunvsm.parallel import audit

    for c in audit.collectives(hlo):
        for _, dims, _ in c.parts:
            _check(
                not (dims and dims[0] >= batch * window),
                f"{label}: word-gradient stream moved as a stream\n"
                + audit.format_table(hlo),
            )
    biggest = audit.max_collective_bytes(hlo)
    _check(
        biggest <= 2 * word_table_bytes + 8192,
        f"{label}: collective of {biggest} bytes\n" + audit.format_table(hlo),
    )
    print(f"[4] {label}: largest collective {biggest} bytes "
          f"(budget {2 * word_table_bytes + 8192})")


def phase_four_cards(s: Sizes):
    import jax
    import jax.numpy as jnp

    from cunvsm.data.device_sampler import (
        make_corpus_sharded_multistep,
        make_device_sampled_sharded_multistep,
        make_epoch_permuter,
        make_sharded_epoch_permuter,
        prepare_device_corpus,
        prepare_sharded_device_corpus,
    )
    from cunvsm.data.synth import zipf_corpus
    from cunvsm.parallel.mesh import make_mesh, make_sharded_train_step
    from cunvsm.parallel.query import make_sharded_scorer
    from cunvsm.train.step import make_train_step

    mesh = make_mesh(2, 2, np.asarray(jax.devices()[:4]))
    card = jax.devices()[0]
    desc, cfg = nvsm_preset(s, uniform_feature_weights=True)
    params, opt_state, batches, keys = reference_inputs(
        s, s.ref_entities, desc, cfg
    )
    # Sharded steps against one card, both at full matmul precision so that
    # only the summation order differs.
    step, p_sh, o_sh = make_sharded_train_step(
        desc, cfg, mesh, params, opt_state, batches[0]
    )
    with jax.default_matmul_precision("highest"):
        costs = []
        for b, k in zip(batches, keys):
            p_sh, o_sh, c = step(p_sh, o_sh, b, k)
            costs.append(c)
        sharded = (np.asarray(jax.device_get(costs)),
                   jax.device_get((p_sh, o_sh)))
    single = run_steps(
        make_train_step(desc, cfg), params, opt_state, batches, keys, card,
        "highest",
    )
    compare_runs(
        f"2x2 mesh vs one card ({s.ref_steps} steps, f32, 'highest')",
        sharded, single, params, TOL["f32_highest"],
    )

    # One device-sampled sharded multistep and one corpus-sharded multistep,
    # with the collective budget read from their compiled HLO.
    num_docs = s.ref_entities
    corpus = zipf_corpus(
        num_docs, s.doc_len, s.num_words, window_size=s.window, seed=3
    )
    _, cfg16 = nvsm_preset(
        s, uniform_feature_weights=True, stream_dtype="bfloat16",
        window_sum_dtype="bfloat16",
    )
    word_table_bytes = s.num_words * s.word_dim * 4
    dc = prepare_device_corpus(corpus)
    permuter, _ = make_epoch_permuter(dc)
    runner, p2, o2 = make_device_sampled_sharded_multistep(
        desc, cfg16, dc, 2, mesh, params, opt_state,
        num_entities=num_docs, epoch_exact=True,
    )
    perm = permuter(jax.random.PRNGKey(8))
    args = (jax.random.PRNGKey(7), perm, 0)
    hlo = runner.lower(p2, o2, *args).compile().as_text()
    p2, o2, costs = runner(p2, o2, *args)
    costs = np.asarray(costs)
    _check(bool(np.all(np.isfinite(costs))), f"non-finite costs {costs}")
    _check(
        tuple(p2.entity_reprs.sharding.spec)[:1] == ("model",),
        f"entity table sharding {p2.entity_reprs.sharding.spec}",
    )
    print(f"[4] device-sampled sharded multistep: costs {costs.tolist()}")
    _audit_collectives(
        hlo, s.batch, s.window, word_table_bytes,
        "device-sampled sharded multistep",
    )

    sdc = prepare_sharded_device_corpus(corpus, mesh)
    sc_runner, p3, o3 = make_corpus_sharded_multistep(
        desc, cfg16, sdc, 2, mesh, p2, o2, num_entities=num_docs
    )
    sc_permute, _ = make_sharded_epoch_permuter(sdc, mesh)
    args = (jax.random.PRNGKey(17), sc_permute(jax.random.PRNGKey(18)), 0)
    sc_hlo = sc_runner.lower(p3, o3, *args).compile().as_text()
    p3, o3, sc_costs = sc_runner(p3, o3, *args)
    sc_costs = np.asarray(sc_costs)
    _check(
        bool(np.all(np.isfinite(sc_costs))), f"non-finite costs {sc_costs}"
    )
    print(f"[4] corpus-sharded multistep: costs {sc_costs.tolist()}")
    _audit_collectives(
        sc_hlo, s.batch, s.window, word_table_bytes,
        "corpus-sharded multistep",
    )

    # Sharded top-k against single-card top-k over the same matrix.
    rng = np.random.RandomState(0)
    docs = rng.randn(num_docs, s.entity_dim).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.randn(s.num_queries, s.entity_dim).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k = min(s.top_k, num_docs)
    with jax.default_matmul_precision("highest"):
        scorer, _ = make_sharded_scorer(mesh, jnp.asarray(docs), top_k=k)
        values, indices = jax.device_get(scorer(jnp.asarray(q)))
        one = jax.jit(lambda q, d: jax.lax.top_k(q @ d.T, k))
        ref_values, ref_indices = jax.device_get(
            one(jax.device_put(q, card), jax.device_put(docs, card))
        )
    score_err = _max_abs(values, ref_values)
    same = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / k
        for a, b in zip(indices, ref_indices)
    ])
    print(
        f"[4] sharded top-{k} over {num_docs} docs vs one card: max score "
        f"diff {score_err:.3e} (tol 1e-5), id overlap {same:.4f}"
    )
    _check(score_err <= 1e-5, f"sharded top-k scores differ by {score_err}")


# ---------------------------------------------------------------------------


def _keep_cpu_backend() -> None:
    """Phase (c) compares against the host CPU: keep JAX's CPU backend
    available next to the GPU when JAX_PLATFORMS names platforms."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the 2x2 mesh path, on four cards",
    )
    args = ap.parse_args(argv)
    _keep_cpu_backend()
    from cunvsm.cli._platform import enable_compile_cache

    import jax

    enable_compile_cache()
    count = 4 if args.four_cards else 1
    try:
        phase_device(count)
    except Exception as exc:  # no card: no result line
        print(f"[a] FAILED: {exc}", file=sys.stderr)
        return 1

    s = Sizes()
    if args.four_cards:
        phases = [("four cards", lambda: phase_four_cards(s))]
    else:
        state = {}

        def train():
            state["params"] = phase_train(s)

        def query():
            _check("params" in state, "no trained params (phase b failed)")
            phase_query(s, state["params"])

        def checkpoint():
            with tempfile.TemporaryDirectory() as workdir:
                phase_checkpoint(s, workdir)

        phases = [
            ("b train", train),
            ("c reference", lambda: phase_reference(s)),
            ("d optimizer", lambda: phase_sweep(s)),
            ("e query", query),
            ("f checkpoint", checkpoint),
        ]
    failed = []
    for name, fn in phases:
        start = time.perf_counter()
        try:
            fn()
            print(f"phase {name}: ok ({time.perf_counter() - start:.1f} s)")
        except Exception:
            failed.append(name)
            print(f"phase {name}: FAILED", flush=True)
            traceback.print_exc()
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
