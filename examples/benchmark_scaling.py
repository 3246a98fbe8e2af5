"""Pod-scale scaling benchmark: rows/s vs corpus-shard count.

The BASELINE.json pod-scale config is a 10M-row x 768d f32 corpus sharded
across N hosts with a k=100 distributed merge.  Real multi-chip hardware is
not available in this environment, so this script measures two things:

1. On the real device (default backend): single-chip throughput on the
   largest corpus that fits HBM (default 2M x 768d f32 = 6 GB), both merge
   paths, k=100 — the per-shard building block of the pod design.
2. On a virtual CPU mesh (--cpu): end-to-end sharded execution at 1/2/4/8
   shards, validating that the distributed path is work-conserving (the
   numbers are NOT performance — CPU mesh devices share one host).

Prints rows/s = n_queries * n_corpus / elapsed (candidate-scoring rate).
"""

import argparse
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench(fn, warmup=1, iters=3):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="virtual 8-device CPU mesh scaling structure test")
    ap.add_argument("--corpus", type=int, default=None,
                    help="corpus rows (default: 1.25M, 20k with --cpu)")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args()

    if args.cpu and "host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""
    ):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import polars_matmul_tpu as pmt
    from polars_matmul_tpu.config import SearchConfig

    n_corpus = args.corpus or (20_000 if args.cpu else 1_250_000)
    dev = jax.devices()[0]
    print(f"device: {len(jax.devices())} x {dev.device_kind}, corpus "
          f"{n_corpus}x{args.dim} f32, {args.queries} queries, k={args.k}")

    rng = np.random.default_rng(42)
    q = rng.standard_normal((args.queries, args.dim)).astype(np.float32)
    # Generate the corpus in slabs to keep host memory reasonable.
    c = rng.standard_normal((n_corpus, args.dim)).astype(np.float32)

    devs = jax.devices()
    shard_counts = [s for s in (1, 2, 4, 8) if s <= len(devs)]
    base_rate = None
    for s in shard_counts:
        mesh = pmt.make_mesh(1, s, devices=devs[:s])
        corpus = pmt.Corpus(c, mesh=mesh)
        for merge in (["allgather", "ring"] if s > 1 else ["allgather"]):
            cfg = SearchConfig(merge=merge)
            corpus.config = cfg
            t = bench(lambda: corpus.topk(q, args.k, "cosine"))
            rate = args.queries * n_corpus / t
            eff = ""
            if s == 1 and merge == "allgather":
                base_rate = rate
            elif base_rate:
                eff = f"  scaling eff {rate / (base_rate * s):.2f}"
            print(f"shards={s} merge={merge:10s}: {t*1e3:9.1f} ms "
                  f"-> {rate/1e9:8.2f} G rows/s{eff}")


if __name__ == "__main__":
    main()
