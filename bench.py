"""Canonical benchmark: top-k on the reference's headline workload, on a GPU.

Workload (reference README.md:162, BASELINE.md): 1000 queries x 10,000
corpus, 256 dims, f32, cosine, k=10.  Reference: ~45 ms end-to-end =>
~22,222 queries/s.

Measures the served path with a resident corpus: ``Corpus.topk`` takes a
host query batch and returns host arrays, so the host clock around each
call covers upload, the scan, and readback.  Results are checked against
a float64 NumPy oracle before timing.  Fails without a GPU.  Prints the
card's name and power limit, then ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_QUERIES, N_CORPUS, DIM, K = 1000, 10_000, 256, 10
BASELINE_S = 0.045  # reference fused topk, README.md:166
BASELINE_QPS = N_QUERIES / BASELINE_S
REPO = os.path.dirname(os.path.abspath(__file__))


def numpy_oracle(q, c, k):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = qn.astype(np.float64) @ cn.astype(np.float64).T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(s, idx, 1)


def main() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"card: {card.stdout.strip().splitlines()[0]}", flush=True)

    import polars_matmul_tpu as pmt

    rng = np.random.default_rng(42)
    q = rng.standard_normal((N_QUERIES, DIM)).astype(np.float32)
    c = rng.standard_normal((N_CORPUS, DIM)).astype(np.float32)
    corpus = pmt.Corpus(c)

    t0 = time.perf_counter()
    idx, scores = corpus.topk(q, K, "cosine")
    compile_s = time.perf_counter() - t0
    ref_idx, ref_scores = numpy_oracle(q, c, K)
    score_ok = np.allclose(scores, ref_scores, rtol=1e-4, atol=1e-5)
    mism = idx != ref_idx  # index diffs allowed only on tied scores
    idx_ok = bool(np.all(np.abs(scores[mism] - ref_scores[mism])
                         <= 1e-5 + 1e-4 * np.abs(ref_scores[mism])))
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if not (score_ok and idx_ok):
        print(json.dumps({"metric": "topk_queries_per_sec", "value": 0.0,
                          "unit": "queries/s", "vs_baseline": 0.0,
                          "device": device,
                          "error": "correctness check failed"}))
        sys.exit(1)

    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        corpus.topk(q, K, "cosine")  # returns host arrays: work is done
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    qps = N_QUERIES / med
    print(json.dumps({
        "metric": "topk_queries_per_sec",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / BASELINE_QPS, 3),
        "latency_ms_median": round(med * 1e3, 3),
        "latency_ms_min": round(min(times) * 1e3, 3),
        "compile_and_first_call_s": round(compile_s, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
