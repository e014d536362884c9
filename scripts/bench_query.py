#!/usr/bin/env python
"""Query-serving latency benchmark (the PERFORMANCE.md serving table).

Measures brute-force cosine top-k latency over a collection-scale document
matrix on the current jax backend, with the scan + device-to-host barrier
methodology (see PERFORMANCE.md's measurement caveat).

    python scripts/bench_query.py [--docs 262144] [--dim 256] [--top_k 1000]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def bench_qlm(num_docs=500_000, vocab=65536, avg_len=200, queries=50, seed=0):
    """Collection-scale QLM+PRF benchmark (Robust04-sized synthetic corpus):
    the round-1 ranker densified a [num_docs] column per query term; the
    postings-based scorer touches only nonzeros."""
    import time

    import scipy.sparse

    from cunvsm.query.qlm import QLMIndex, qlm_rank

    rng = np.random.RandomState(seed)
    # Zipf-ish term distribution, ~avg_len distinct terms per doc.
    nnz = num_docs * 60
    rows = rng.randint(0, num_docs, nnz)
    terms = (vocab * rng.power(0.25, nnz)).astype(np.int64) % vocab
    counts = rng.randint(1, 5, nnz).astype(np.float64)
    mat = scipy.sparse.coo_matrix(
        (counts, (rows, terms)), shape=(num_docs, vocab)
    ).tocsr()
    cf = np.asarray(mat.sum(axis=0)).ravel()
    index = QLMIndex(
        doc_term=mat,
        doc_lengths=np.asarray(mat.sum(axis=1)).ravel(),
        collection_prob=cf / max(cf.sum(), 1.0),
        docnos=[str(i) for i in range(num_docs)],
        term_to_id={f"t{i}": i for i in range(vocab)},
    )
    qs = {
        str(q): [f"t{t}" for t in rng.randint(0, vocab, 4)]
        for q in range(queries)
    }
    index.doc_term_csc  # build outside the timing
    for smoothing, prf in (("jm", False), ("jm", True), ("dirichlet", True)):
        t0 = time.time()
        run = qlm_rank(index, qs, smoothing=smoothing, prf=prf)
        dt = time.time() - t0
        print(f"qlm {smoothing} prf={prf}: {1000*dt/len(qs):.1f} ms/query "
              f"({num_docs} docs, {len(run)} queries)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--docs", type=int, default=262144)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--word_dim", type=int, default=300)
    p.add_argument("--top_k", type=int, default=1000)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--qlm", action="store_true",
                   help="run the collection-scale QLM ranker benchmark (CPU)")
    args = p.parse_args(argv)

    if args.qlm:
        bench_qlm()
        return 0

    import jax
    import jax.numpy as jnp

    from cunvsm.cli._platform import enable_compile_cache

    enable_compile_cache()
    rng = np.random.RandomState(0)
    E = rng.randn(args.docs, args.dim).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    W = jax.device_put(
        jnp.asarray(rng.randn(args.word_dim, args.dim).astype(np.float32))
    )

    def serve(q_reprs, Emat, Wmat):
        proj = q_reprs @ Wmat
        proj = proj / jnp.linalg.norm(proj, axis=1, keepdims=True)
        scores = jnp.dot(
            proj.astype(Emat.dtype), Emat.T,
            preferred_element_type=jnp.float32,
        )
        v, i = jax.lax.top_k(scores, args.top_k)
        return v, i

    for dtype, tag in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        Emat = jax.device_put(jnp.asarray(E, dtype))
        for Q in (1, 16):
            qs = jnp.asarray(rng.randn(Q, args.word_dim).astype(np.float32))

            def scanned(qs, Emat, Wmat):
                def body(c, _):
                    v, _i = serve(qs + c * 1e-20, Emat, Wmat)
                    return c + v[0, 0] * 1e-9, ()

                out, _ = jax.lax.scan(
                    body, jnp.zeros(()), None, length=args.iters
                )
                return out

            g = jax.jit(scanned)
            float(g(qs, Emat, W))  # compile + warm
            t0 = time.time()
            float(g(qs, Emat, W))  # D2H barrier
            dt = (time.time() - t0) / args.iters * 1000
            print(
                f"E {tag} Q={Q:3d}: {dt:7.3f} ms/serve "
                f"({dt / Q * 1000:8.1f} us/query) "
                f"top-{args.top_k} over {args.docs} docs"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
