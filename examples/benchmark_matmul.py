"""Raw pairwise-matmul benchmark sweep vs NumPy.

Port of the reference's examples/benchmark_matmul.py (f32+f64, Array-vs-List
input comparison — here: zero-copy FixedSizeList vs ragged List Arrow columns
— and flatten mode, around 1000x10000x256d)."""

import argparse
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np
import pyarrow as pa


def bench(fn, warmup=2, iters=5):
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
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    import polars_matmul_tpu as pmt

    print(f"device: {jax.devices()[0].device_kind}")
    rng = np.random.default_rng(42)
    n_q, n_c, dim = 1000, 10000, 256

    print(f"{'case':<40} {'numpy':>9} {'pmm':>9} {'ratio':>7}")
    for dtype in (np.float32, np.float64):
        q = rng.standard_normal((n_q, dim)).astype(dtype)
        c = rng.standard_normal((n_c, dim)).astype(dtype)
        t_np = bench(lambda: q @ c.T)

        # NumPy-matrix API
        t_mm = bench(lambda: pmt.matmul(q, c))
        name = f"matmul {dtype.__name__} (ndarray)"
        print(f"{name:<40} {t_np*1e3:8.1f}ms {t_mm*1e3:8.1f}ms {t_mm/t_np:6.2f}x")

        # Arrow FixedSizeList (zero-copy path)
        qa = pa.FixedSizeListArray.from_arrays(pa.array(q.reshape(-1)), dim)
        ca = pa.FixedSizeListArray.from_arrays(pa.array(c.reshape(-1)), dim)
        t_fsl = bench(lambda: pmt.matmul_arrow(qa, ca))
        name = f"matmul {dtype.__name__} (Arrow FixedSizeList)"
        print(f"{name:<40} {t_np*1e3:8.1f}ms {t_fsl*1e3:8.1f}ms {t_fsl/t_np:6.2f}x")

        # Arrow ragged List (copy/pack path)
        ql = pa.array(q.tolist(), type=pa.list_(pa.from_numpy_dtype(dtype)))
        cl = pa.array(c.tolist(), type=pa.list_(pa.from_numpy_dtype(dtype)))
        t_l = bench(lambda: pmt.matmul_arrow(ql, cl))
        name = f"matmul {dtype.__name__} (Arrow List)"
        print(f"{name:<40} {t_np*1e3:8.1f}ms {t_l*1e3:8.1f}ms {t_l/t_np:6.2f}x")

    # flatten mode
    q32 = rng.standard_normal((n_q, dim)).astype(np.float32)
    c32 = rng.standard_normal((n_c, dim)).astype(np.float32)
    qa = pa.FixedSizeListArray.from_arrays(pa.array(q32.reshape(-1)), dim)
    ca = pa.FixedSizeListArray.from_arrays(pa.array(c32.reshape(-1)), dim)
    t_flat = bench(lambda: pmt.matmul_arrow(qa, ca, flatten=True))
    print(f"{'matmul f32 flatten=True':<40} {'':>9} {t_flat*1e3:8.1f}ms")

    # correctness spot-check
    out = pmt.matmul(q32[:8], c32[:16])
    np.testing.assert_allclose(out, q32[:8] @ c32[:16].T, rtol=1e-5, atol=1e-5)
    print("correctness: verified vs NumPy")


if __name__ == "__main__":
    main()
