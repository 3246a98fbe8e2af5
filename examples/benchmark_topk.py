"""End-to-end top-k benchmark sweep vs NumPy.

Port of the reference's examples/benchmark_topk.py (sweep around the base
workload 1000 queries x 10,000 corpus x 256d, k=10, f32 cosine, varying one
axis at a time; ratio table vs a NumPy normalize+matmul+argpartition
baseline; self-verifies correctness first — reference
benchmark_topk.py:122-138).  Runs on whatever device JAX selects (the GPU
when there is one); pass --cpu to force CPU.
"""

import argparse
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np


def numpy_topk_cosine(query, corpus, k):
    """Reference NumPy implementation (benchmark_topk.py:14-33)."""
    qn = query / np.linalg.norm(query, axis=1, keepdims=True)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    scores = qn @ cn.T
    idx = np.argpartition(-scores, min(k, scores.shape[1] - 1), axis=1)[:, :k]
    part = np.take_along_axis(scores, idx, 1)
    order = np.argsort(-part, axis=1)
    return np.take_along_axis(idx, order, 1), np.take_along_axis(part, order, 1)


def bench(fn, warmup=2, iters=5):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def verify_correctness(corpus_handle, q, c, k):
    idx, scores = corpus_handle.topk(q, k, "cosine")
    ref_idx, ref_scores = numpy_topk_cosine(
        q.astype(np.float64), c.astype(np.float64), k
    )
    if not np.allclose(scores, ref_scores, rtol=1e-4, atol=1e-5):
        raise AssertionError("score mismatch vs NumPy oracle")
    mism = idx != ref_idx
    if mism.any():
        ok = np.abs(scores[mism] - ref_scores[mism]) <= (
            1e-5 + 1e-4 * np.abs(ref_scores[mism])
        )
        if not ok.all():
            raise AssertionError("index mismatch vs NumPy oracle (non-tie)")
    return True


def run_case(n_queries, n_corpus, dim, k, dtype):
    import polars_matmul_tpu as pmt

    rng = np.random.default_rng(42)
    q = rng.standard_normal((n_queries, dim)).astype(dtype)
    c = rng.standard_normal((n_corpus, dim)).astype(dtype)

    t_np = bench(lambda: numpy_topk_cosine(q, c, k))

    corpus = pmt.Corpus(c)  # resident corpus: upload once
    verify_correctness(corpus, q, c, k)
    t_us = bench(lambda: corpus.topk(q, k, "cosine"))

    return t_np, t_us


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    print(f"device: {jax.devices()[0].device_kind}")
    print(f"{'case':<42} {'numpy':>9} {'pmm':>9} {'ratio':>7}  (<1 = faster)")
    base = dict(n_queries=1000, n_corpus=10000, dim=256, k=10, dtype=np.float32)
    sweeps = [
        ("base 1000x10000x256 k=10 f32", {}),
        ("queries=100", {"n_queries": 100}),
        ("queries=5000", {"n_queries": 5000}),
        ("corpus=1000", {"n_corpus": 1000}),
        ("corpus=100000", {"n_corpus": 100000}),
        ("dim=64", {"dim": 64}),
        ("dim=1024", {"dim": 1024}),
        ("k=1", {"k": 1}),
        ("k=100", {"k": 100}),
        ("f64", {"dtype": np.float64}),
    ]
    for name, over in sweeps:
        cfg = {**base, **over}
        t_np, t_us = run_case(**cfg)
        print(
            f"{name:<42} {t_np*1e3:8.1f}ms {t_us*1e3:8.1f}ms "
            f"{t_us/t_np:6.2f}x"
        )
    print("correctness: verified vs NumPy on every case")


if __name__ == "__main__":
    main()
