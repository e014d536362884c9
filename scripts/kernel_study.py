"""Plain XLA against hand-written Pallas kernels (Triton route) on one GPU.

Measures, at the canonical NVSM shapes (word table 65536x300, entity table
262144x256, batch 51200, window 10):

* the full_adam dense sweep (m, v and the table in one elementwise pass):
  the formula of optim/updates.py:_repr_adam_full as XLA compiles it,
  against a Pallas kernel through Triton; both against 7*R*4 bytes at the
  data-sheet 3.35 TB/s and at the bandwidth a plain copy reaches;
* the same two inside the whole canonical step (timed in the order X, T,
  T, X);
* the f32 -> bf16 word-table cast: ``astype`` against a Pallas kernel;
* word-gradient accumulation on Zipf ids: the sorted segment-sum of
  optim/updates.py against a plain unsorted ``segment_sum``;
* the compiled step's HLO: which fusions write the optimizer state and the
  bf16 table copy;
* a device trace of a few canonical steps, reduced by scripts/profile_step.

Standalone kernel times are device busy time per call from a profiler
trace, so host dispatch is not counted; the step is also timed on the host.

Usage: python scripts/kernel_study.py [--out build/kernel_study.json]
       [--trace_dir build/trace_kernel_study]
Prints one line per measurement and writes all of them to ``--out``.
"""

import argparse
import functools
import json
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet

RESULTS = {}


def record(key, value):
    RESULTS[key] = value
    print(f"{key}: {json.dumps(value)}", flush=True)


def device_seconds(trace_dir, run, calls=10):
    """Device busy time per call of run(i), from a profiler trace of
    ``calls`` back-to-back calls after one untraced warm-up call: the time
    the card spends in the call's kernels, without host dispatch."""
    import jax

    from profile_step import device_summary

    jax.block_until_ready(run(-1))
    with jax.profiler.trace(trace_dir):
        for i in range(calls):
            out = run(i)
        jax.block_until_ready(out)
    devices = device_summary(trace_dir)["devices"].values()
    return sum(d["busy_ns"] for d in devices) / calls / 1e9


def rates(nbytes, secs, copy_rate=None):
    out = {"device_us": secs * 1e6, "GB_per_s": nbytes / secs / 1e9,
           "share_of_3.35TBps": nbytes / secs / PEAK_BYTES_PER_S}
    if copy_rate:
        out["share_of_copy"] = nbytes / secs / copy_rate
    return out


# ---------------------------------------------------------------------------
# Pallas kernels through Triton: one program per block of a flattened array.
# ---------------------------------------------------------------------------


def _sweep_kernel(scale_ref, s_ref, m_ref, v_ref, p_ref, m_out, v_out,
                  p_out, *, n, block, beta1, beta2, lam, eps):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    import jax.numpy as jnp

    idx = pl.program_id(0) * block + jnp.arange(block)
    mask = idx < n
    s = plgpu.load(s_ref.at[idx], mask=mask, other=0.0)
    m = plgpu.load(m_ref.at[idx], mask=mask, other=0.0)
    v = plgpu.load(v_ref.at[idx], mask=mask, other=0.0)
    p = plgpu.load(p_ref.at[idx], mask=mask, other=0.0)
    agg = s - lam * p
    m_new = beta1 * m + (1.0 - beta1) * agg
    v_new = beta2 * v + (1.0 - beta2) * agg * agg
    p_new = p + scale_ref[...] * m_new / (jnp.sqrt(v_new) + eps)
    plgpu.store(m_out.at[idx], m_new, mask=mask)
    plgpu.store(v_out.at[idx], v_new, mask=mask)
    plgpu.store(p_out.at[idx], p_new, mask=mask)


def triton_sweep(table, m, v, scattered, step_scale, *, lam, beta1, beta2,
                 eps, block=2048, num_warps=8, interpret=False):
    """(m', v', table') of one full_adam sweep; m, v, table updated in
    place."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    shape, n = table.shape, table.size
    kernel = functools.partial(
        _sweep_kernel, n=n, block=block, beta1=beta1, beta2=beta2, lam=lam,
        eps=eps,
    )
    flat = jax.ShapeDtypeStruct((n,), table.dtype)
    outs = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block),),
        out_shape=(flat, flat, flat),
        input_output_aliases={2: 0, 3: 1, 4: 2},
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        backend="triton",
        interpret=interpret,
        name="adam_full_sweep",
    )(
        jnp.asarray(step_scale, table.dtype),
        scattered.reshape(n), m.reshape(n), v.reshape(n), table.reshape(n),
    )
    return tuple(o.reshape(shape) for o in outs)


def xla_sweep(table, m, v, scattered, step_scale, *, lam, beta1, beta2, eps):
    """The formula of optim/updates.py:_repr_adam_full."""
    import jax.numpy as jnp

    agg = scattered - lam * table
    m = beta1 * m + (1.0 - beta1) * agg
    v = beta2 * v + (1.0 - beta2) * jnp.square(agg)
    return m, v, table + step_scale * m / (jnp.sqrt(v) + eps)


def _cast_kernel(x_ref, o_ref, *, n, block):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    import jax.numpy as jnp

    idx = pl.program_id(0) * block + jnp.arange(block)
    mask = idx < n
    x = plgpu.load(x_ref.at[idx], mask=mask, other=0.0)
    plgpu.store(o_ref.at[idx], x.astype(o_ref.dtype), mask=mask)


def triton_cast(x, dtype, block=4096, num_warps=8, interpret=False):
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = x.size
    out = pl.pallas_call(
        functools.partial(_cast_kernel, n=n, block=block),
        grid=(pl.cdiv(n, block),),
        out_shape=jax.ShapeDtypeStruct((n,), dtype),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        backend="triton",
        interpret=interpret,
        name="table_cast",
    )(x.reshape(n))
    return out.reshape(x.shape)


def row_block_cast(x, dtype, block_rows=1024):
    """The row-block Pallas cast as it was written for the earlier
    accelerator: no backend named, so the default GPU route compiles it."""
    import jax
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...].astype(o_ref.dtype)

    n, d = x.shape
    block_rows = min(block_rows, n)
    row = pl.BlockSpec((block_rows, d), lambda i: (i, 0))
    return pl.pallas_call(
        kernel, grid=(pl.cdiv(n, block_rows),), in_specs=[row],
        out_specs=row, out_shape=jax.ShapeDtypeStruct(x.shape, dtype),
    )(x)


# ---------------------------------------------------------------------------


ADAM = dict(lam=1e-2 / 51200, beta1=0.9, beta2=0.999, eps=1e-6)


def study_copy(trace_dir):
    import jax
    import jax.numpy as jnp

    x = jnp.ones((262144, 1024), jnp.float32)  # 1 GiB
    f = jax.jit(lambda x: x * 2.0)
    secs = device_seconds(os.path.join(trace_dir, "copy"), lambda i: f(x))
    nbytes = 2 * x.size * 4
    record("copy_1GiB", rates(nbytes, secs))
    return nbytes / secs


def study_sweep(trace_dir, copy_rate):
    import jax
    import jax.numpy as jnp

    for rows, dim in ((262144, 256), (65536, 300)):
        rng = np.random.RandomState(0)
        s, m, v, p = [
            jnp.asarray((scale * rng.randn(rows, dim)).astype(np.float32))
            for scale in (1e-2, 1e-3, 1e-3, 5e-2)
        ]
        v = jnp.abs(v)
        scale = jnp.float32(3e-4)
        nbytes = 7 * rows * dim * 4
        ref = jax.device_get(
            jax.jit(functools.partial(xla_sweep, **ADAM))(p, m, v, s, scale)
        )
        variants = {"xla": functools.partial(xla_sweep, **ADAM)}
        for block, warps in ((1024, 4), (2048, 8), (4096, 8)):
            variants[f"triton_b{block}_w{warps}"] = functools.partial(
                triton_sweep, block=block, num_warps=warps, **ADAM)
        for name, fn in variants.items():
            key = f"sweep_{rows}x{dim}_{name}"
            fn = jax.jit(fn, donate_argnums=(0, 1, 2))
            try:
                out = jax.device_get(
                    fn(jnp.copy(p), jnp.copy(m), jnp.copy(v), s, scale)
                )
                err = max(float(np.max(np.abs(a - b)))
                          for a, b in zip(out, ref))
                # table, m and v donated and fed back, as the step runs it.
                carry = [jnp.copy(p), jnp.copy(m), jnp.copy(v)]

                def run(i, fn=fn, carry=carry):
                    carry[1], carry[2], carry[0] = fn(*carry, s, scale)
                    return carry[0]

                secs = device_seconds(os.path.join(trace_dir, key), run)
            except Exception as exc:  # a refusal is a finding too
                record(key, {"error": f"{type(exc).__name__}: "
                             f"{str(exc).splitlines()[0][:300]}"})
                continue
            record(key, dict(rates(nbytes, secs, copy_rate),
                             max_abs_diff_vs_xla=err))


def canonical_step_inputs(num_entities=262144):
    import jax
    import jax.numpy as jnp

    from cunvsm.config import (
        AdamConfig, AdamMode, ModelDesc, Nonlinearity, TrainConfig,
        UpdateMethod,
    )
    from cunvsm.models.objectives import TextEntityBatch
    from cunvsm.models.params import init_params
    from cunvsm.optim.updates import Optimizer

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
    )
    from chip_smoke import zipf_ids

    rng = np.random.RandomState(0)
    batch = TextEntityBatch(
        features=jnp.asarray(zipf_ids(rng, (51200, 10), 65536)),
        feature_weights=jnp.ones((51200, 10), jnp.float32),
        labels=jnp.asarray(rng.randint(0, num_entities, 51200), jnp.int32),
        weights=jnp.ones((51200,), jnp.float32),
    )
    params = init_params(jax.random.PRNGKey(0), 65536, num_entities, desc)
    return desc, cfg, params, Optimizer(cfg).init(params), batch


def _triton_repr_adam_full(state, table, descs, lr, lam, beta1, beta2, eps,
                           stream_dtype=None, accum_dtype=None,
                           data_shard_mesh=None, reduce_dtype=None):
    """optim/updates.py:_repr_adam_full with the sweep as a Pallas kernel
    (single card only)."""
    from cunvsm.optim import updates as U

    scattered = U._sorted_segment_accumulate(
        table.shape[0], tuple(descs), stream_dtype, accum_dtype
    )
    bc = U._adam_bias_correction(beta1, beta2, state.t, table.dtype)
    m, v, table = triton_sweep(
        table, state.m, state.v, scattered, lr * bc,
        lam=lam, beta1=beta1, beta2=beta2, eps=eps,
    )
    return U.ReprAdamState(m, v, state.t + 1), table


def fusions_writing(hlo, shape):
    """Fusion instructions of the compiled module whose result has
    ``shape`` (e.g. 'f32[262144,256]') among its outputs."""
    out = []
    for line in hlo.splitlines():
        m = re.match(r"\s*(ROOT )?%?([\w.\-]+) = (.*?) fusion\(", line)
        if m and shape in m.group(3):
            out.append({"name": m.group(2), "result": m.group(3)[:300],
                        "count": m.group(3).count(shape)})
    return out


def study_step(trace_dir, steps=20):
    import jax

    from cunvsm.optim import updates as U
    from cunvsm.train.step import make_train_step

    desc, cfg, params, opt_state, batch = canonical_step_inputs()
    host = jax.device_get((params, opt_state))
    step_x = make_train_step(desc, cfg)
    lowered = step_x.lower(params, opt_state, batch, jax.random.PRNGKey(0))
    compiled = lowered.compile()
    hlo = compiled.as_text()
    mem = compiled.memory_analysis()
    record("step_hlo", {
        "entity_state_fusions": fusions_writing(hlo, "f32[262144,256]"),
        "word_state_fusions": fusions_writing(hlo, "f32[65536,300]"),
        "bf16_word_table_fusions": fusions_writing(hlo, "bf16[65536,300]"),
        "peak_bytes": getattr(mem, "peak_memory_in_bytes", None),
        "temp_bytes": mem.temp_size_in_bytes,
        "argument_bytes": mem.argument_size_in_bytes,
    })

    orig = U._repr_adam_full
    U._repr_adam_full = _triton_repr_adam_full
    try:
        step_t = make_train_step(desc, cfg)
        p, o = jax.device_put(host)
        p, o, c = step_t(p, o, batch, jax.random.PRNGKey(0))
        jax.block_until_ready(c)
    finally:
        U._repr_adam_full = orig

    state = {"xla": jax.device_put(host), "triton": jax.device_put(host)}
    fns = {"xla": step_x, "triton": step_t}
    times = {"xla": [], "triton": []}
    costs = {}
    for name in ("xla", "triton", "triton", "xla"):
        p, o = state[name]
        p, o, c = fns[name](p, o, batch, jax.random.PRNGKey(1))
        jax.block_until_ready(c)
        start = time.perf_counter()
        for i in range(steps):
            p, o, c = fns[name](p, o, batch, jax.random.PRNGKey(2 + i))
        jax.block_until_ready(c)
        times[name].append((time.perf_counter() - start) / steps)
        costs[name] = float(c)
        state[name] = (p, o)
    record("step_ms", {
        name: {"per_step_ms": [t * 1e3 for t in ts],
               "pairs_per_s": [51200 / t for t in ts],
               "last_cost": costs[name]}
        for name, ts in times.items()
    })
    for name in ("xla", "triton"):
        carry = list(state[name])

        def run_step(i, carry=carry, fn=fns[name]):
            carry[0], carry[1], c = fn(
                carry[0], carry[1], batch, jax.random.PRNGKey(40 + i))
            return c

        trace_summary(f"trace_step_{name}",
                      os.path.join(trace_dir, f"step_{name}"), run_step)


def trace_summary(key, trace_dir, run_step, steps=5):
    """Trace ``steps`` calls of run_step(i) and record the device time of
    each kernel, per step, with the busy and idle share of the window."""
    import jax

    from profile_step import device_summary

    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        for i in range(steps):
            with jax.profiler.StepTraceAnnotation("train", step_num=i):
                out = run_step(i)
        jax.block_until_ready(out)
    summary = device_summary(trace_dir)
    for plane, dev in summary["devices"].items():
        top = sorted(dev["kernels"].items(), key=lambda kv: -kv[1][0])[:30]
        record(f"{key}_{plane}", {
            "steps": steps,
            "busy_ms_per_step": dev["busy_ns"] / steps / 1e6,
            "window_ms": dev["window_ns"] / 1e6,
            "idle_share": dev["idle_share"],
            "top_kernels_us_per_step": [
                [name[:120], ns / steps / 1e3, n // steps]
                for name, (ns, n) in top
            ],
        })


def study_cast(trace_dir, copy_rate):
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(
        np.random.RandomState(1).randn(65536, 300).astype(np.float32)
    )
    nbytes = x.size * 6
    ref = np.asarray(x.astype(jnp.bfloat16))
    variants = {
        "xla_astype": jax.jit(lambda x: x.astype(jnp.bfloat16)),
        "triton": jax.jit(lambda x: triton_cast(x, jnp.bfloat16)),
        "row_block_default_route": jax.jit(
            lambda x: row_block_cast(x, jnp.bfloat16)),
    }
    for name, fn in variants.items():
        try:
            same = bool(np.array_equal(np.asarray(fn(x)), ref))
            secs = device_seconds(os.path.join(trace_dir, f"cast_{name}"),
                                  lambda i, fn=fn: fn(x))
        except Exception as exc:
            record(f"cast_{name}", {"error": f"{type(exc).__name__}: "
                                    f"{str(exc).splitlines()[0][:300]}"})
            continue
        record(f"cast_{name}", dict(rates(nbytes, secs, copy_rate),
                                    bit_identical=same))


def study_accumulate(trace_dir):
    import jax
    import jax.numpy as jnp

    from chip_smoke import zipf_ids
    from cunvsm.models.objectives import SparseGrad
    from cunvsm.optim.updates import _sorted_segment_accumulate

    B, W, V, d = 51200, 10, 65536, 300
    rng = np.random.RandomState(2)
    idx = jnp.asarray(zipf_ids(rng, (B, W), V))
    grad = jnp.asarray((1e-2 * rng.randn(B, d)).astype(np.float32))
    for stream in (None, "bfloat16"):

        def sorted_acc(g, i, stream=stream):
            return _sorted_segment_accumulate(
                V, (SparseGrad(g, i, None),), stream)

        def unsorted_acc(g, i, stream=stream):
            if stream is not None:
                g = g.astype(stream).astype(jnp.float32)
            upd = jnp.broadcast_to(g[:, None, :], (B, W, d)).reshape(-1, d)
            return jax.ops.segment_sum(upd, i.reshape(-1), num_segments=V)

        fs = {"sorted": jax.jit(sorted_acc), "unsorted": jax.jit(unsorted_acc)}
        ref = np.asarray(fs["sorted"](grad, idx))
        for name, fn in fs.items():
            key = f"accumulate_{stream or 'float32'}_{name}"
            diff = float(np.max(np.abs(np.asarray(fn(grad, idx)) - ref)))
            secs = device_seconds(os.path.join(trace_dir, key),
                                  lambda i, fn=fn: fn(grad, idx))
            record(key, {"device_us": secs * 1e6,
                         "max_abs_diff_vs_sorted": diff})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/kernel_study.json")
    ap.add_argument("--trace_dir", default="build/trace_kernel_study")
    args = ap.parse_args()

    import jax

    from cunvsm.cli._platform import device_record, enable_compile_cache

    enable_compile_cache()
    device = device_record()
    if device["platform"] != "gpu":
        print(f"no GPU (JAX's first device is {device['platform']})",
              file=sys.stderr)
        return 1
    record("device", dict(device, jax=jax.__version__))
    trace_dir = args.trace_dir
    copy_rate = study_copy(trace_dir)
    for study in (lambda: study_sweep(trace_dir, copy_rate),
                  lambda: study_step(trace_dir),
                  lambda: study_cast(trace_dir, copy_rate),
                  lambda: study_accumulate(trace_dir)):
        try:
            study()
        except Exception as exc:
            import traceback

            traceback.print_exc()
            record("error", f"{type(exc).__name__}: {exc}"[:500])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RESULTS, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
