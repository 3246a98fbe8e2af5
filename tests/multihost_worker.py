"""Worker process for the multi-host distributed test (not a test module).

Launched by tests/test_multihost.py as one of N processes; initializes the
JAX multi-host runtime via the package's own ``init_distributed`` wrapper
(parallel/mesh.py), builds a mesh SPANNING PROCESSES (each process
contributes 4 virtual CPU devices), and runs ``distributed_topk`` —
allgather and ring merges — against the single-process NumPy oracle.

SPMD contract: every process runs this same program; per-process results
are fully-replicated global arrays, so each process can fetch and verify
them locally.  Prints MULTIHOST_OK on success (the parent asserts it).
"""

import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    # Per-process virtual CPU devices BEFORE jax import.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import numpy as np

    from polars_matmul_tpu.parallel.mesh import init_distributed, make_mesh

    # The component under test (VERDICT r01: parallel/mesh.py:18-23 had no
    # coverage): a real multi-process runtime with a local coordinator.
    init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )

    import jax

    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())
    assert len(jax.local_devices()) == 4

    import polars_matmul_tpu as pmt
    from polars_matmul_tpu.config import SearchConfig

    mesh = make_mesh(1, 4 * nproc)
    # The mesh must actually span processes, or this test proves nothing.
    procs = {d.process_index for d in mesh.devices.flat}
    assert len(procs) == nproc, f"mesh spans only processes {procs}"

    rng = np.random.default_rng(321)
    q = rng.standard_normal((19, 48)).astype(np.float32)
    c = rng.standard_normal((203, 48)).astype(np.float32)  # padding: 203 % 8
    k = 10

    # Oracle (computed identically in every process): exact f64 cosine.
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = qn.astype(np.float64) @ cn.astype(np.float64).T
    ref_idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    ref_val = np.take_along_axis(s, ref_idx, 1)

    def check(v, i, tag):
        v = np.asarray(v).astype(np.float64)
        i = np.asarray(i)
        assert np.allclose(v, ref_val, rtol=2e-5, atol=8e-6), (
            f"{tag}: scores diverge (max err "
            f"{np.abs(v - ref_val).max():.2e})")
        mism = i != ref_idx
        if mism.any():
            # index swaps are only legal between numerically tied scores
            assert np.all(
                np.abs(v[mism] - ref_val[mism])
                <= 8e-6 + 2e-5 * np.abs(ref_val[mism])
            ), f"{tag}: index mismatch without score tie"

    from jax.sharding import NamedSharding, PartitionSpec as P

    qj = jax.device_put(q, NamedSharding(mesh, P()))  # replicated queries

    for merge in ("allgather", "ring"):
        cfg = SearchConfig(merge=merge)
        sharded = pmt.shard_corpus(c, mesh, cfg)
        assert sharded.n_true == c.shape[0]
        v, i = pmt.distributed_topk(qj, sharded, k, "cosine", mesh, cfg)
        # Results are replicated over the 1-row data axis: every process
        # holds the full answer and verifies it independently.
        check(v, i, merge)

    # ---- big-k (k > 128, round 4) across processes -------------------------
    # Shard kernels clamp to shard size; what big-k exercises here is the
    # merge re-select with the auto-raised carry width on a mesh that
    # spans processes.
    kb = 150
    refb_idx = np.argsort(-s, axis=1, kind="stable")[:, :kb]
    refb_val = np.take_along_axis(s, refb_idx, 1)
    cfgb = SearchConfig()
    shardedb = pmt.shard_corpus(c, mesh, cfgb)
    vb, ib = pmt.distributed_topk(qj, shardedb, kb, "cosine", mesh, cfgb)
    vb = np.asarray(vb).astype(np.float64)
    ib = np.asarray(ib)
    assert np.allclose(vb, refb_val, rtol=2e-5, atol=8e-6), (
        f"bigk: scores diverge (max err {np.abs(vb - refb_val).max():.2e})")
    mismb = ib != refb_idx
    assert np.all(np.abs(vb[mismb] - refb_val[mismb])
                  <= 8e-6 + 2e-5 * np.abs(refb_val[mismb])), \
        "bigk: index mismatch without score tie"

    # ---- int8 shared-storage shards on the spanning mesh ------------------
    # (VERDICT r02 item 7: the multi-host matrix covered only f32.)  The
    # oracle is exact search over the DEQUANTIZED rows — quantization error
    # is part of the contract, merge/layout error is not.
    from polars_matmul_tpu.kernels.fused_topk import quantize_int8

    codes, scales = map(np.asarray, quantize_int8(c))
    cd = codes.astype(np.float64) * scales[:, None].astype(np.float64)
    cdn = cd / np.linalg.norm(cd, axis=1, keepdims=True)
    s8 = qn.astype(np.float64) @ cdn.T
    ref8_idx = np.argsort(-s8, axis=1, kind="stable")[:, :k]
    ref8_val = np.take_along_axis(s8, ref8_idx, 1)

    cfg = SearchConfig()
    sh8 = pmt.shard_corpus(codes, mesh, cfg, scales=scales, storage="int8")
    v8, i8 = pmt.distributed_topk(qj, sh8, k, "cosine", mesh, cfg)
    v8 = np.asarray(v8).astype(np.float64)
    i8 = np.asarray(i8)
    assert np.allclose(v8, ref8_val, rtol=2e-4, atol=1e-5), (
        f"int8: scores diverge (max err {np.abs(v8 - ref8_val).max():.2e})")
    mism = i8 != ref8_idx
    assert np.all(np.abs(v8[mism] - ref8_val[mism])
                  <= 1e-5 + 2e-4 * np.abs(ref8_val[mism])), \
        "int8: index mismatch without score tie"

    # ---- probed (clustered) mesh path across processes ---------------------
    rngb = np.random.default_rng(99)
    centers = rngb.standard_normal((6, 48)).astype(np.float32) * 4
    cb = (centers[rngb.integers(0, 6, 1500)]
          + 0.3 * rngb.standard_normal((1500, 48))).astype(np.float32)
    qb = (centers[rngb.integers(0, 6, 16)]
          + 0.3 * rngb.standard_normal((16, 48))).astype(np.float32)
    cm = pmt.ClusteredCorpus(cb, clusters=6, mesh=mesh)
    # NumPy dense oracle (a single-device Corpus would not be addressable
    # from every process)
    qbn = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    cbn = cb / np.linalg.norm(cb, axis=1, keepdims=True)
    ref_i = np.argsort(
        -(qbn.astype(np.float64) @ cbn.astype(np.float64).T),
        axis=1, kind="stable")[:, :5]
    pi, pv = cm.topk(qb, 5, "cosine", probe=0.6)
    hits = sum(len(set(pi[r]) & set(np.asarray(ref_i)[r]))
               for r in range(len(qb)))
    recall = hits / (len(qb) * 5)
    assert recall > 0.8, f"probed mesh recall {recall:.2f}"

    # ---- 2 x (2*nproc) mesh: DATA axis spanning processes ------------------
    # Queries shard over 'data' (each process computes half the batch);
    # every process verifies the shards it can address.
    mesh2 = make_mesh(2, 2 * nproc)
    procs2 = {d.process_index for d in mesh2.devices[:, 0].flat}
    assert len(procs2) == nproc, "data axis must span processes"
    m2 = 16  # divisible by the data axis
    q2 = q[:m2]
    qd = jax.device_put(q2, NamedSharding(mesh2, P("data", None)))
    sh2 = pmt.shard_corpus(c, mesh2, SearchConfig())
    v2, i2 = pmt.distributed_topk(qd, sh2, k, "cosine", mesh2,
                                  SearchConfig())
    for vs, is_ in zip(v2.addressable_shards, i2.addressable_shards):
        rows = vs.index[0]
        gv = np.asarray(vs.data).astype(np.float64)
        gi = np.asarray(is_.data)
        wv, wi = ref_val[:m2][rows], ref_idx[:m2][rows]
        assert np.allclose(gv, wv, rtol=2e-5, atol=8e-6), (
            f"data-sharded scores diverge in shard {vs.index}")
        mism = gi != wi
        assert np.all(np.abs(gv[mism] - wv[mism])
                      <= 8e-6 + 2e-5 * np.abs(wv[mism])), (
            f"data-sharded index mismatch without tie in shard {vs.index}")

    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
