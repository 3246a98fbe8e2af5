"""Serving pattern: resident corpus, batch accumulation, filtered queries.

Shows the intended production loop (SURVEY.md §5 resident-corpus design):
upload + prepare the corpus once, then serve query batches against it —
optionally with per-request corpus filters — and read one packed result
per batch.  ``--small`` shrinks the corpus for a quick run on a CPU.
"""

import time

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import polars_matmul_tpu as pmt  # noqa: E402


def main():
    import jax

    small = "--small" in sys.argv[1:]
    n, dim, k = (5_000, 64, 10) if small else (200_000, 256, 10)
    batch = 512

    rng = np.random.default_rng(0)
    corpus_emb = rng.standard_normal((n, dim)).astype(np.float32)
    # a categorical attribute to filter on per request
    category = rng.integers(0, 8, size=n)

    print(f"corpus {n}x{dim} on {jax.devices()[0].device_kind}; "
          f"uploading + preparing once...")
    t0 = time.perf_counter()
    corpus = pmt.Corpus(corpus_emb)
    # warm the prepared cache for the metric we serve
    corpus.topk(corpus_emb[:1], 1, "cosine")
    print(f"  ready in {time.perf_counter() - t0:.1f}s")

    # steady-state serving loop
    lat = []
    for req in range(5):
        queries = rng.standard_normal((batch, dim)).astype(np.float32)
        want = req % 8  # this request only wants category == want
        t0 = time.perf_counter()
        idx, scores = corpus.topk(queries, k, "cosine",
                                  mask=category == want)
        lat.append(time.perf_counter() - t0)
        assert (category[idx.reshape(-1)] == want).all()
        print(f"  request {req}: {batch} queries (category {want}) "
              f"in {lat[-1]*1e3:.1f} ms; "
              f"top hit score {scores[0, 0]:.4f}")

    qps = batch / min(lat)
    print(f"steady-state: {qps:,.0f} queries/s per batch-call "
          f"(transport-bound off-chip; see bench.py for device rates)")

    # --- live index mutation: upsert / append / delete ---------------------
    # All in-place (donated row writes into the cached prepared forms);
    # the compiled search program never recompiles.
    fresh = rng.standard_normal((64, dim)).astype(np.float32)
    corpus2 = pmt.Corpus(corpus_emb[:5000], capacity=8000, storage="int8")
    corpus2.topk(fresh[:1], 1)                  # build the prepared form
    t0 = time.perf_counter()
    corpus2.add(fresh)                          # new docs: ids 5000..5063
    corpus2.update([17, 123], fresh[:2])        # re-embedded docs
    corpus2.delete([44])                        # retired doc
    print(f"mutations (add 64 / update 2 / delete 1) in "
          f"{(time.perf_counter() - t0)*1e3:.1f} ms (first mutation "
          f"compiles the splice programs; the SEARCH program never "
          f"recompiles)")
    idx, _ = corpus2.topk(fresh[:2], 1)
    assert idx[0, 0] == 17 and idx[1, 0] == 123  # upserts serve instantly

    # --- persistence: storage-native save / load ---------------------------
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "corpus.npz")
    corpus2.save(path)                          # int8: quarter-size file
    restored = pmt.Corpus.load(path)
    idx2, _ = restored.topk(fresh[:2], 1)
    assert (idx2 == idx).all()
    print(f"saved + reloaded {restored.n} rows "
          f"({os.path.getsize(path)/1e6:.1f} MB int8 file); "
          f"results identical")

    # --- probed (IVF-style) serving with drift recovery --------------------
    # probe= bounds corpus bytes read; add() places rows by the centroids
    # fitted at construction, so after heavy growth the fit goes stale.
    # `drift` is the cheap signal; rebuild() re-fits storage-native
    # (exhaustive results invariant, ids/tombstones stable).
    cc = pmt.ClusteredCorpus(corpus_emb[:5000], storage="int8")
    cc.topk(fresh[:8], 5, probe=0.2)            # ~20% of corpus bytes
    cc.add(rng.standard_normal((2000, dim)).astype(np.float32))
    print(f"drift after heavy adds: {cc.drift:.0%} of rows placed "
          f"against stale centroids")
    if cc.drift > 0.25:
        t0 = time.perf_counter()
        cc.rebuild()
        print(f"rebuild (re-fit + re-layout, never requantizes) in "
              f"{(time.perf_counter() - t0)*1e3:.0f} ms; drift reset "
              f"to {cc.drift:.0%}")
    cc.topk(fresh[:8], 5, probe=0.2)            # serves the fresh layout


if __name__ == "__main__":
    main()
