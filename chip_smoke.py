"""One pass over the served search path on an NVIDIA GPU, checked against
plain references.

    python chip_smoke.py                 # phases 1-4 and the card-only tests
    python chip_smoke.py --four-cards    # the sharded path on 4 GPUs only

Everything runs in this one process (a second JAX process could not get
the card's memory); ``nvidia-smi`` runs in a child that never imports JAX.
Data is generated from ``--seed``; nothing is downloaded.  Each phase
prints one line: what ran, compile seconds, warm wall milliseconds (calls
that end on host results or ``block_until_ready``), the device's
``peak_bytes_in_use``, and the oracle comparison with its tolerance.  Any
failed check ends the run with a non-zero exit and no result line.  The
last line is ``{"ok": true, "device": {...}}``.

Without a GPU (or outside the repository) the script fails before it
prints a result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def setup_jax():
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX found {devs[0].platform} devices")
    return jax, devs


def peak_bytes(jax) -> int:
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def timed(fn, reps: int = 3):
    """(first-call seconds, [warm ms]) for a call that returns host data
    or device arrays (waited for with block_until_ready)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm.append((time.perf_counter() - t0) * 1e3)
    return first, warm


def report(phase: str, what: str, first_s: float, warm_ms, peak: int,
           check: str) -> None:
    ms = " ".join(f"{t:.3f}" for t in warm_ms)
    print(f"[{phase}] {what} | compile+first {first_s:.2f} s | warm ms "
          f"{ms} | peak_bytes_in_use {peak} | {check}", flush=True)


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------


def host_scores(q, c, metric):
    """float64 NumPy scores (the reference's metric definitions)."""
    q = q.astype(np.float64)
    c = c.astype(np.float64)
    d = q @ c.T
    if metric == "dot":
        return d
    if metric == "cosine":
        qn = np.linalg.norm(q, axis=1)[:, None]
        cn = np.linalg.norm(c, axis=1)[None, :]
        return d / (qn * cn)
    sq = (q * q).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * d
    return np.sqrt(np.maximum(sq, 0.0))


def check_topk(idx, vals, s_ref, k, higher, rtol, atol, what):
    """Scores within (rtol, atol) of the oracle's k best; an index may
    differ from the oracle's only where the two scores tie within the
    same band."""
    order = np.argsort(-s_ref if higher else s_ref, axis=1,
                       kind="stable")[:, :k]
    want = np.take_along_axis(s_ref, order, axis=1)
    vals = np.asarray(vals, np.float64)
    idx = np.asarray(idx).astype(np.int64)
    if not np.allclose(vals, want, rtol=rtol, atol=atol):
        bad = np.max(np.abs(vals - want) / (atol + rtol * np.abs(want)))
        fail(f"{what}: scores off the oracle ({bad:.2f}x tolerance)")
    got = np.take_along_axis(s_ref, np.clip(idx, 0, s_ref.shape[1] - 1),
                             axis=1)
    mism = idx != order
    if mism.any() and not np.all(
            np.abs(got[mism] - want[mism])
            <= atol + rtol * np.abs(want[mism])):
        fail(f"{what}: index differs from the oracle without a score tie")
    return (f"oracle ok: scores rtol {rtol:g} atol {atol:g}, "
            f"{int(mism.sum())} index swaps all on ties")


# ---------------------------------------------------------------------------
# Phase 1: the reference's canonical call
# ---------------------------------------------------------------------------


def phase_canonical(pmt, jax, rng) -> None:
    q = rng.standard_normal((1000, 256)).astype(np.float32)
    c = rng.standard_normal((10_000, 256)).astype(np.float32)
    tol = {"bf16x3": (1e-4, 1e-5), "highest": (1e-5, 1e-6)}
    for precision, (rtol, atol) in tol.items():
        cfg = pmt.SearchConfig(precision=precision)
        handle = pmt.Corpus(c, config=cfg)
        for metric in ("cosine", "dot", "euclidean"):
            s_ref = host_scores(q, c, metric)
            higher = metric != "euclidean"
            for k in (10, 100):
                first, warm = timed(lambda: pmt.topk(q, c, k, metric,
                                                     config=cfg))
                i, v = pmt.topk(q, c, k, metric, config=cfg)
                chk = check_topk(i, v, s_ref, k, higher, rtol, atol,
                                 f"topk {precision} {metric} k={k}")
                report("1", f"pmt.topk 1000x10000x256 {precision} "
                       f"{metric} k={k}", first, warm, peak_bytes(jax), chk)
                first, warm = timed(lambda: handle.topk(q, k, metric))
                i, v = handle.topk(q, k, metric)
                chk = check_topk(i, v, s_ref, k, higher, rtol, atol,
                                 f"Corpus.topk {precision} {metric} k={k}")
                report("1", f"Corpus.topk 1000x10000x256 {precision} "
                       f"{metric} k={k}", first, warm, peak_bytes(jax), chk)
    for dt in (np.float32, np.float64):
        qq, cc = q.astype(dt), c.astype(dt)
        first, warm = timed(lambda: pmt.matmul(qq, cc))
        out = pmt.matmul(qq, cc)
        ref = qq.astype(np.float64) @ cc.astype(np.float64).T
        rtol = 1e-5 if dt == np.float32 else 1e-12
        if out.dtype != dt or not np.allclose(out, ref, rtol=rtol,
                                              atol=rtol * 10):
            fail(f"matmul {np.dtype(dt).name} off the NumPy product")
        report("1", f"pmt.matmul 1000x10000x256 {np.dtype(dt).name}",
               first, warm, peak_bytes(jax),
               f"oracle ok: rtol {rtol:g}")
    handle = pmt.Corpus(c)
    handle.delete(np.arange(0, 10_000, 2))       # every even row
    keep = np.zeros(10_000, bool)
    keep[[1, 3, 4, 5, 7]] = True                 # 4 is deleted
    i, v = handle.topk(q[:16], 6, "cosine", mask=keep)
    if not (set(i[:, :4].ravel()) <= {1, 3, 5, 7}
            and (i[:, 4:] == np.iinfo(np.int32).max).all()
            and np.isneginf(v[:, 4:]).all()):
        fail("masked Corpus.delete call: sentinels or excluded rows wrong")
    report("1", "Corpus.delete + mask, k=6 over 4 live rows", 0.0, [],
           peak_bytes(jax), "sentinels ok: (-inf, int32-max) in slots 4-5")


# ---------------------------------------------------------------------------
# Phases 2 and 5: a 10M x 768 int8 corpus, exact chunked oracle on device
# ---------------------------------------------------------------------------

N_BIG, DIM_BIG, CHUNK = 10_000_000, 768, 1_000_000


def device_rows(jax, key, rows: int):
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(key, (rows, DIM_BIG), jnp.float32))


def build_big(pmt, jax, seed: int, mesh=None):
    handle = None
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    for r0 in range(0, N_BIG, CHUNK):
        rows = device_rows(jax, jax.random.fold_in(key, r0), CHUNK)
        if handle is None:
            handle = pmt.Corpus(rows, storage="int8", capacity=N_BIG,
                                mesh=mesh)
        else:
            handle.add(rows)
    return handle, time.perf_counter() - t0


def chunked_oracle(jax, codes, scales, q, k: int):
    """Exact cosine top-(k+1) over dequantized rows, chunk by chunk, at
    HIGHEST precision; merged on the host in float64."""
    import jax.numpy as jnp

    @jax.jit
    def chunk_top(cq, sc, qn):
        x = cq.astype(jnp.float32) * sc[:, None]
        x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
        s = jax.lax.dot_general(qn, x, (((1,), (1,)), ((), ())),
                                precision=jax.lax.Precision.HIGHEST)
        return jax.lax.top_k(s, k + 1)

    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vals, idx = [], []
    for r0 in range(0, N_BIG, CHUNK):
        v, i = chunk_top(codes[r0:r0 + CHUNK, :DIM_BIG],
                         scales[r0:r0 + CHUNK], jnp.asarray(qn))
        vals.append(np.asarray(v, np.float64))
        idx.append(np.asarray(i, np.int64) + r0)
    vals = np.concatenate(vals, axis=1)
    idx = np.concatenate(idx, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")[:, :k + 1]
    return (np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(idx, order, axis=1))


def check_big(i, v, ov, oi, k: int, what: str) -> str:
    """Index-set recall 1.0 on every query whose k-th and (k+1)-th exact
    scores are more than 1e-5 apart; scores within 1e-4 relative."""
    v = np.asarray(v, np.float64)[: ov.shape[0]]
    i = np.asarray(i, np.int64)[: ov.shape[0]]
    if not np.allclose(v, ov[:, :k], rtol=1e-4, atol=1e-6):
        dv = np.abs(v - ov[:, :k])
        r, j = np.unravel_index(np.argmax(dv), dv.shape)
        fail(f"{what}: scores off the chunked oracle beyond 1e-4: worst "
             f"query {r} slot {j} got {v[r, j]!r} (row {i[r, j]}) want "
             f"{ov[r, j]!r} (row {oi[r, j]})")
    clear = (ov[:, k - 1] - ov[:, k]) > 1e-5
    rec = [len(set(i[r]) & set(oi[r, :k])) / k for r in range(len(i))]
    if not all(rec[r] == 1.0 for r in range(len(i)) if clear[r]):
        fail(f"{what}: recall {rec} below 1.0 on a tie-free query")
    return (f"oracle ok: recall@{k} {np.mean(rec):.4f} "
            f"({int(clear.sum())}/{len(i)} tie-free queries at 1.0), "
            "scores rtol 1e-4")


def run_big(pmt, jax, handle, q, phase: str, label: str, oracle):
    ov, oi = oracle
    for b in (8, 256):
        qb = q[:b]
        first, warm = timed(lambda: handle.topk(qb, 100, "cosine"))
        i, v = handle.topk(qb, 100, "cosine")
        chk = check_big(i, v, ov, oi, 100, f"{label} batch {b}")
        report(phase, f"{label} {N_BIG}x{DIM_BIG} int8 cosine k=100 "
               f"batch {b}",
               first, warm, peak_bytes(jax), chk)


def phase_big(pmt, jax, seed: int) -> None:
    handle, build_s = build_big(pmt, jax, seed)
    print(f"[2] built Corpus(storage='int8') {N_BIG}x{DIM_BIG} with "
          f"add() in {CHUNK}-row chunks: {build_s:.1f} s", flush=True)
    q = np.random.default_rng(seed + 1).standard_normal(
        (256, DIM_BIG)).astype(np.float32)
    oracle = chunked_oracle(jax, handle._device, handle._scales, q[:8], 100)
    run_big(pmt, jax, handle, q, "2", "Corpus.topk", oracle)


def phase_four_cards(pmt, jax, seed: int) -> None:
    mesh = pmt.make_mesh(1, 4)
    # An f32 corpus at its default tier (bf16x3: each shard runs the
    # Triton step at k <= 16, the XLA step above), against the float64
    # host oracle.
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1000, 256)).astype(np.float32)
    c = rng.standard_normal((10_000, 256)).astype(np.float32)
    s_ref = host_scores(q, c, "cosine")
    handle = pmt.Corpus(c, mesh=mesh)
    for merge in ("allgather", "ring"):
        handle.config = handle.config.with_updates(merge=merge)
        for k in (10, 100):
            first, warm = timed(lambda: handle.topk(q, k, "cosine"))
            i, v = handle.topk(q, k, "cosine")
            chk = check_topk(i, v, s_ref, k, True, 1e-4, 1e-5,
                             f"sharded {merge} f32 k={k}")
            report("5", f"sharded {merge} 1000x10000x256 f32 bf16x3 "
                   f"cosine k={k}", first, warm, peak_bytes(jax), chk)
    del handle
    handle, build_s = build_big(pmt, jax, seed, mesh=mesh)
    print(f"[5] built Corpus(storage='int8', mesh=make_mesh(1, 4)) "
          f"{N_BIG}x{DIM_BIG}: {build_s:.1f} s", flush=True)
    q = np.random.default_rng(seed + 1).standard_normal(
        (256, DIM_BIG)).astype(np.float32)
    sc = handle._device
    oracle = chunked_oracle(jax, sc.data, sc.scales, q[:8], 100)
    for merge in ("allgather", "ring"):
        handle.config = handle.config.with_updates(merge=merge)
        run_big(pmt, jax, handle, q, "5", f"sharded {merge}", oracle)


# ---------------------------------------------------------------------------
# Phase 3: probed search on a clustered int8 corpus
# ---------------------------------------------------------------------------


N_PROBED = 1_000_000


def check_same_as_dense(jax, codes, q, ei, ev, di, dv, what: str) -> str:
    """The clustered result equals the dense one: scores within rtol 1e-5,
    no row listed twice, and an index may differ from the dense result
    only where the two rows' exact scores (float64 over the int8 codes)
    tie within that band."""
    import jax.numpy as jnp

    rtol, atol = 1e-5, 1e-6
    ei, di = np.asarray(ei, np.int64), np.asarray(di, np.int64)
    if not np.allclose(ev, dv, rtol=rtol, atol=atol):
        fail(f"{what}: scores differ from the dense Corpus")
    if any(len(set(r)) != len(r) for r in ei):
        fail(f"{what}: a row is listed twice in one query's result")
    mism = ei != di
    if mism.any():
        rows = np.unique(np.concatenate([ei[mism], di[mism]]))
        x = np.asarray(jnp.take(codes, jnp.asarray(rows), axis=0),
                       np.float64)[:, :q.shape[1]]
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        qn = q.astype(np.float64)
        qn /= np.linalg.norm(qn, axis=1, keepdims=True)
        exact = dict(zip(rows.tolist(), range(len(rows))))
        r_of = np.nonzero(mism)[0]
        s = lambda ids: np.einsum(  # noqa: E731
            "ij,ij->i", qn[r_of], x[[exact[i] for i in ids.tolist()]])
        got, want = s(ei[mism]), s(di[mism])
        if not np.all(np.abs(got - want) <= atol + rtol * np.abs(want)):
            fail(f"{what}: index differs from the dense Corpus without an "
                 "exact score tie")
    return (f"equals dense Corpus: scores rtol {rtol:g} atol {atol:g}, "
            f"{int(mism.sum())} index swaps all on exact ties")


def phase_probed(pmt, jax, seed: int) -> None:
    import jax.numpy as jnp

    n, dim = N_PROBED, DIM_BIG
    key = jax.random.PRNGKey(seed + 3)
    kc, ka, kn, kq = jax.random.split(key, 4)
    centers = jax.random.normal(kc, (1000, dim), jnp.float32)
    assign = jax.random.randint(ka, (n,), 0, 1000)
    c = np.asarray(centers[assign]
                   + 0.5 * jax.random.normal(kn, (n, dim), jnp.float32))
    qa = jax.random.randint(kq, (64,), 0, 1000)
    q = np.asarray(centers[qa] + 0.5 * jax.random.normal(
        jax.random.fold_in(kq, 1), (64, dim), jnp.float32))
    t0 = time.perf_counter()
    cc = pmt.ClusteredCorpus(c, storage="int8", seed=seed)
    dense = pmt.Corpus(c, storage="int8")
    print(f"[3] built ClusteredCorpus(storage='int8') {n}x{dim} "
          f"({cc.clusters} clusters, {cc.n_tiles} tiles) and the dense "
          f"Corpus: {time.perf_counter() - t0:.1f} s", flush=True)
    di, dv = dense.topk(q, 100, "cosine")
    first, warm = timed(lambda: cc.topk(q, 100, "cosine", probe=None))
    ei, ev = cc.topk(q, 100, "cosine", probe=None)
    chk = check_same_as_dense(jax, dense._device, q, ei, ev, di, dv,
                              "probe=None")
    report("3", f"ClusteredCorpus.topk probe=None {n}x{dim} int8 k=100 "
           "batch 64", first, warm, peak_bytes(jax), chk)
    first, warm = timed(lambda: cc.topk(q, 100, "cosine", probe=0.1))
    pi, pv = cc.topk(q, 100, "cosine", probe=0.1)
    rec = np.mean([len(set(pi[r]) & set(di[r])) / 100 for r in range(64)])
    report("3", f"ClusteredCorpus.topk probe=0.1 {n}x{dim} int8 k=100 "
           "batch 64", first, warm, peak_bytes(jax),
           f"recall@100 vs dense {rec:.4f}")


# ---------------------------------------------------------------------------
# Phase 4: the Arrow surface
# ---------------------------------------------------------------------------


def phase_arrow(pmt, jax, rng) -> None:
    try:
        import pyarrow as pa
    except ImportError as e:
        print(f"[4] Arrow surface not run: pyarrow is not installed ({e})",
              flush=True)
        return
    q = rng.standard_normal((1000, 256)).astype(np.float32)
    c = rng.standard_normal((10_000, 256)).astype(np.float32)
    qa = pa.FixedSizeListArray.from_arrays(pa.array(q.ravel()), 256)
    ca = pa.FixedSizeListArray.from_arrays(pa.array(c.ravel()), 256)
    first, warm = timed(lambda: pmt.topk_arrow(qa, ca, 10, "cosine"))
    out = pmt.topk_arrow(qa, ca, 10, "cosine")
    flat = out.flatten()
    idx = np.asarray(flat.field("index")).reshape(1000, 10)
    val = np.asarray(flat.field("score")).reshape(1000, 10)
    chk = check_topk(idx, val, host_scores(q, c, "cosine"), 10, True,
                     1e-4, 1e-5, "topk_arrow")
    report("4", "topk_arrow 1000x10000x256 cosine k=10", first, warm,
           peak_bytes(jax), chk)
    first, warm = timed(lambda: pmt.matmul_arrow(qa, ca))
    out = pmt.matmul_arrow(qa, ca)
    mat = np.asarray(out.flatten()).reshape(1000, 10_000)
    if not np.allclose(mat, q.astype(np.float64) @ c.T.astype(np.float64),
                       rtol=1e-5, atol=1e-4):
        fail("matmul_arrow off the NumPy product")
    report("4", "matmul_arrow 1000x10000x256 f32", first, warm,
           peak_bytes(jax), "oracle ok: rtol 1e-5")


def phase_card_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    if rc != 0:
        fail(f"card-only tests failed (pytest exit {rc})")
    print("[6] card-only tests (pytest -m gpu) passed", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded phase")
    args = ap.parse_args()

    jax, devs = setup_jax()
    import polars_matmul_tpu as pmt

    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)
    rng = np.random.default_rng(args.seed)
    if args.four_cards:
        if len(devs) < 4:
            fail(f"--four-cards needs 4 GPUs, found {len(devs)}")
        phase_four_cards(pmt, jax, args.seed)
    else:
        phase_canonical(pmt, jax, rng)
        phase_big(pmt, jax, args.seed)
        phase_probed(pmt, jax, args.seed)
        phase_arrow(pmt, jax, rng)
        phase_card_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
