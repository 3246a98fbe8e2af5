"""Performance gates (port of reference tests/test_performance.py).

Thresholds are deliberately loose (reference uses 12x headroom for CI
variability, test_performance.py:73); these run on the CPU backend in the
normal test environment, so they gate against pathological regressions
(accidental O(n^2) host loops, per-row allocation), not device speed —
bench.py and chip_smoke.py measure on the GPU.
"""

import time

import numpy as np

import polars_matmul_tpu as pmt


def _bench(fn, warmup=1, iters=5):
    # min, not median: the gates compare best-case costs and must shrug off
    # scheduler noise when the suite runs under load.
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


class TestPerformance:
    def test_matmul_vs_numpy(self):
        """reference test_performance_vs_numpy: ratio < 12x on 100x1000x128."""
        rng = np.random.default_rng(42)
        q = rng.standard_normal((100, 128))
        c = rng.standard_normal((1000, 128))
        t_np = _bench(lambda: q @ c.T, warmup=2, iters=5)
        t_us = _bench(lambda: pmt.matmul(q, c), warmup=2, iters=5)
        ratio = t_us / t_np
        print(f"\nmatmul 100x1000x128 f64: numpy {t_np*1e3:.2f}ms "
              f"vs ours {t_us*1e3:.2f}ms ({ratio:.1f}x)")
        assert ratio < 12.0

    def test_matmul_correctness_vs_numpy(self):
        """reference test_correctness_vs_numpy: rtol 1e-5."""
        rng = np.random.default_rng(42)
        q = rng.standard_normal((10, 32))
        c = rng.standard_normal((20, 32))
        np.testing.assert_allclose(pmt.matmul(q, c), q @ c.T, rtol=1e-5)

    def test_topk_performance(self):
        """reference test_topk_performance: 50x500x64 k=10 under 1s."""
        rng = np.random.default_rng(42)
        q = rng.standard_normal((50, 64))
        c = rng.standard_normal((500, 64))
        pmt.topk(q, c, 10)  # warmup/compile outside the timed region
        t = _bench(lambda: pmt.topk(q, c, 10))
        print(f"\ntopk 50x500x64 k=10: {t*1e3:.2f}ms")
        assert t < 1.0

    def test_f32_not_slower_than_f64(self):
        """reference test_f32_performance: f32 <= 1.5x f64 time."""
        rng = np.random.default_rng(42)
        q64 = rng.standard_normal((100, 128))
        c64 = rng.standard_normal((1000, 128))
        q32, c32 = q64.astype(np.float32), c64.astype(np.float32)
        pmt.matmul(q64, c64), pmt.matmul(q32, c32)  # compile
        t64 = _bench(lambda: pmt.matmul(q64, c64), warmup=2, iters=5)
        t32 = _bench(lambda: pmt.matmul(q32, c32), warmup=2, iters=5)
        ratio = t32 / t64
        print(f"\nf32 {t32*1e3:.2f}ms vs f64 {t64*1e3:.2f}ms ({ratio:.2f}x)")
        assert ratio < 1.5

    def test_topk_output_assembly_is_flat(self):
        """The List[Struct] output must be built from flat buffers, not a
        per-row Python loop (SURVEY.md §2 C9: do NOT replicate).  Gate: 20k
        queries assemble in well under a second."""
        import pyarrow as pa

        from polars_matmul_tpu.interop.arrow import topk_to_arrow

        n, k = 20000, 10
        idx = np.zeros((n, k), np.uint32)
        scores = np.zeros((n, k), np.float64)
        t = _bench(lambda: topk_to_arrow(idx, scores))
        print(f"\ntopk_to_arrow 20000x10: {t*1e3:.2f}ms")
        assert t < 0.25
