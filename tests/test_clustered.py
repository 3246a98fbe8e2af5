"""ClusteredCorpus + probed-search kernel path.

The probed path must be EXACT over the visited rows (the kernel change
is only WHICH tiles are visited), so every test either pins
exhaustive-scan equality against Corpus/the oracle, or checks recall on
clusterable data where the centroid probe has signal.
"""

import numpy as np
import pytest

import polars_matmul_tpu as pmt
from polars_matmul_tpu.config import SearchConfig
from polars_matmul_tpu.ops.cluster import (
    assign_rows,
    cluster_layout,
    kmeans,
    resolve_probe,
)

from conftest import assert_topk_equivalent

CFG = SearchConfig(block_q=8, block_n=128)


def blobs(rng, n, m, dim, n_centers=20, spread=4.0):
    centers = rng.standard_normal((n_centers, dim)) * spread
    c = (centers[rng.integers(0, n_centers, n)]
         + rng.standard_normal((n, dim))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, m)]
         + rng.standard_normal((m, dim))).astype(np.float32)
    return q, c


def recall(approx_idx, exact_idx):
    k = exact_idx.shape[1]
    return np.mean([len(set(a) & set(b)) / k
                    for a, b in zip(approx_idx, exact_idx)])


# ---------------------------------------------------------------------------
# layout + probe plumbing
# ---------------------------------------------------------------------------


def test_cluster_layout_invariants():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 7, 900).astype(np.int32)
    lay = cluster_layout(a, 7, 128)
    assert lay.n_padded % 128 == 0
    live = lay.perm >= 0
    # a bijection over the real rows
    assert np.array_equal(np.sort(lay.perm[live]), np.arange(900))
    assert np.array_equal(lay.perm[lay.row_pos], np.arange(900))
    # every tile is single-cluster
    for t in range(lay.n_tiles):
        seg = lay.perm[t * 128:(t + 1) * 128]
        ids = a[seg[seg >= 0]]
        assert (ids == lay.tile_cluster[t]).all()
    # counts add up and empty clusters own no tiles
    assert lay.counts.sum() == 900
    assert np.array_equal(
        np.bincount(lay.tile_cluster, minlength=7) * 128,
        (lay.counts + 127) // 128 * 128,
    )


def test_kmeans_converges_on_blobs():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((5, 8)) * 10
    x = (centers[np.repeat(np.arange(5), 60)]
         + 0.05 * rng.standard_normal((300, 8))).astype(np.float32)
    cent, a = kmeans(x, 5, iters=10, seed=0)
    a = np.asarray(a)
    # Lloyd's from random init may split a blob (local optimum), but each
    # tight blob must be internally consistent: all 60 rows of a blob that
    # share a cluster with any other blob's rows would mean centroids
    # collapsed across blob boundaries — with 10-sigma separation the
    # majority cluster of each blob must be pure.
    for b in range(5):
        blob = a[b * 60:(b + 1) * 60]
        maj = np.bincount(blob).argmax()
        outside = np.delete(a, np.s_[b * 60:(b + 1) * 60])
        assert not (outside == maj).any()
    # the chunked full-corpus assignment is exactly the kernel's own
    full = assign_rows(x, cent, chunk_rows=128)
    assert np.array_equal(full, a)


def test_resolve_probe():
    assert resolve_probe(None, 40) == (40, True)
    assert resolve_probe(0.25, 40) == (10, False)
    assert resolve_probe(1.0, 40) == (40, True)
    assert resolve_probe(3, 40) == (3, False)
    assert resolve_probe(100, 40) == (40, True)
    with pytest.raises(ValueError):
        resolve_probe(0.0, 40)
    with pytest.raises(ValueError):
        resolve_probe(-2, 40)
    with pytest.raises(TypeError):
        resolve_probe(True, 40)


# ---------------------------------------------------------------------------
# probed scan (tiles= on fused_topk_prepared)
# ---------------------------------------------------------------------------


class TestProbedKernel:
    def _prep(self, q, c, metric="cosine", cfg=CFG):
        import jax.numpy as jnp

        from polars_matmul_tpu.kernels.fused_topk import (
            prepare_corpus, query_block_rows)

        tn = cfg.block_n
        tm = query_block_rows(q.shape[0], cfg)
        cp, cbp = prepare_corpus(jnp.asarray(c), metric,
                                 precision=cfg.precision)
        return cp, cbp, tn, tm

    def test_all_tiles_equals_dense(self):
        from polars_matmul_tpu.kernels.fused_topk import fused_topk_prepared

        rng = np.random.default_rng(2)
        q = rng.standard_normal((20, 32)).astype(np.float32)
        c = rng.standard_normal((1000, 32)).astype(np.float32)
        cp, cbp, tn, tm = self._prep(q, c)
        n_tiles = -(-cbp.shape[1] // tn)
        qb = -(-20 // tm)
        tiles = np.tile(np.arange(n_tiles, dtype=np.int32), (qb, 1))
        v1, i1 = fused_topk_prepared(q, cp, cbp, 5, "cosine", tn=tn,
                                     config=CFG, tiles=tiles)
        v0, i0 = fused_topk_prepared(q, cp, cbp, 5, "cosine", tn=tn,
                                     config=CFG)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v0))

    def test_subset_equals_restricted_oracle(self):
        from polars_matmul_tpu.kernels.fused_topk import fused_topk_prepared

        rng = np.random.default_rng(3)
        q = rng.standard_normal((20, 32)).astype(np.float32)
        c = rng.standard_normal((1000, 32)).astype(np.float32)
        cp, cbp, tn, tm = self._prep(q, c)
        qb = -(-20 // tm)
        tiles = np.tile(np.array([0, 3], np.int32), (qb, 1))
        v, i = fused_topk_prepared(q, cp, cbp, 5, "cosine", tn=tn,
                                   config=CFG, tiles=tiles)
        rows = np.r_[0:tn, 3 * tn:4 * tn]
        rows = rows[rows < 1000]
        qq = q / np.linalg.norm(q, axis=1, keepdims=True)
        cc = c / np.linalg.norm(c, axis=1, keepdims=True)
        s = (qq @ cc.T)[:, rows]
        oi = np.argsort(-s, axis=1, kind="stable")[:, :5]
        np.testing.assert_array_equal(np.asarray(i), rows[oi])

    def test_per_block_tile_lists(self):
        from polars_matmul_tpu.kernels.fused_topk import fused_topk_prepared

        rng = np.random.default_rng(4)
        q = rng.standard_normal((20, 32)).astype(np.float32)
        c = rng.standard_normal((1000, 32)).astype(np.float32)
        cp, cbp, tn, tm = self._prep(q, c)
        qb = -(-20 // tm)
        tiles = np.tile(np.array([2, 3], np.int32), (qb, 1))
        tiles[0] = [0, 1]
        _, i = fused_topk_prepared(q, cp, cbp, 5, "cosine", tn=tn,
                                   config=CFG, tiles=tiles)
        i = np.asarray(i)
        assert i[:tm].max() < 2 * tn
        assert i[tm:].min() >= 2 * tn

    def test_too_many_tiles_rejected(self):
        from polars_matmul_tpu.kernels.fused_topk import fused_topk_prepared

        rng = np.random.default_rng(5)
        q = rng.standard_normal((8, 32)).astype(np.float32)
        c = rng.standard_normal((300, 32)).astype(np.float32)
        cp, cbp, tn, tm = self._prep(q, c)
        n_tiles = -(-cbp.shape[1] // tn)
        tiles = np.zeros((1, n_tiles + 1), np.int32)
        with pytest.raises(ValueError, match="tiles"):
            fused_topk_prepared(q, cp, cbp, 5, "cosine", tn=tn,
                                config=CFG, tiles=tiles)

    def test_wrong_block_count_rejected(self):
        from polars_matmul_tpu.kernels.fused_topk import fused_topk_prepared

        rng = np.random.default_rng(6)
        q = rng.standard_normal((20, 32)).astype(np.float32)
        c = rng.standard_normal((1000, 32)).astype(np.float32)
        cp, cbp, tn, tm = self._prep(q, c)
        tiles = np.zeros((99, 2), np.int32)
        with pytest.raises(ValueError, match="query blocks"):
            fused_topk_prepared(q, cp, cbp, 5, "cosine", tn=tn,
                                config=CFG, tiles=tiles)


# ---------------------------------------------------------------------------
# ClusteredCorpus end-to-end
# ---------------------------------------------------------------------------


class TestClusteredCorpus:
    @pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
    def test_exhaustive_matches_corpus(self, metric):
        rng = np.random.default_rng(7)
        q, c = blobs(rng, 3000, 25, 24)
        cc = pmt.ClusteredCorpus(c, clusters=16, config=CFG)
        ref = pmt.Corpus(c, config=CFG)
        ei, ev = cc.topk(q, 10, metric, probe=None)
        ri, rv = ref.topk(q, 10, metric)
        # The default selection (gpop/gstack since round 3) packs the
        # corpus-group id into the score's low mantissa bits, and the
        # clustered handle scans a PERMUTED layout — so near-ties within
        # the <=127-ulp truncation band may come back in either order
        # (euclidean amplifies the band through the final sqrt when
        # |2qc - |c||| is large).  Pair-consistent, not bit-identical.
        assert_topk_equivalent(ei, ev, ri, rv, rtol=1e-4, atol=5e-4)

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_matmul_matches_corpus_handle(self, storage):
        """ClusteredCorpus.matmul must agree with Corpus.matmul at every
        storage tier (both dequantize the SAME codes, so the panels are
        equal up to accumulation order) and with the f32 oracle within
        that tier's quantization error."""
        rng = np.random.default_rng(21)
        q, c = blobs(rng, 2000, 6, 24)
        cc = pmt.ClusteredCorpus(c, clusters=8, storage=storage, config=CFG)
        pc = pmt.Corpus(c, storage=storage, config=CFG)
        np.testing.assert_allclose(cc.matmul(q), pc.matmul(q),
                                   rtol=1e-4, atol=1e-3)
        if storage == "f32":
            np.testing.assert_allclose(cc.matmul(q), q @ c.T,
                                       rtol=1e-4, atol=1e-3)

    def test_matmul_dim_mismatch_and_empty(self):
        rng = np.random.default_rng(22)
        q, c = blobs(rng, 500, 4, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            cc.matmul(np.ones((2, 7), np.float32))
        out = cc.matmul(np.empty((0, 16), np.float32))
        assert out.shape == (0, 500)
        # host-owned: mutating the result must not poison later calls
        p1 = cc.matmul(q)
        p1[:] = -1.0
        np.testing.assert_allclose(cc.matmul(q)[0, 0], (q @ c.T)[0, 0],
                                   rtol=1e-4, atol=1e-4)

    def test_probed_recall_on_blobs(self):
        rng = np.random.default_rng(8)
        q, c = blobs(rng, 5000, 40, 32, n_centers=30)
        cc = pmt.ClusteredCorpus(c, clusters=30, config=CFG)
        ri, _ = pmt.Corpus(c, config=CFG).topk(q, 10, "cosine")
        pi, _ = cc.topk(q, 10, "cosine", probe=0.25)
        assert recall(pi, ri) > 0.9

    def test_probed_subset_property(self):
        """Whatever the probe visits, scores must be exact: every probed
        (index, score) pair must appear in the full score matrix."""
        rng = np.random.default_rng(9)
        q, c = blobs(rng, 1200, 10, 16)
        cc = pmt.ClusteredCorpus(c, clusters=8, config=CFG)
        pi, pv = cc.topk(q, 5, "cosine", probe=2)
        qq = q / np.linalg.norm(q, axis=1, keepdims=True)
        ccn = c / np.linalg.norm(c, axis=1, keepdims=True)
        s = qq @ ccn.T
        for r in range(10):
            for j in range(5):
                if pi[r, j] >= c.shape[0]:
                    continue  # sentinel
                assert abs(s[r, pi[r, j]] - pv[r, j]) < 1e-4

    @pytest.mark.parametrize("storage", ["bf16", "int8", "int4"])
    def test_storage_agrees_with_quantized_corpus(self, storage):
        rng = np.random.default_rng(10)
        q, c = blobs(rng, 2000, 15, 24)
        cc = pmt.ClusteredCorpus(c, clusters=12, storage=storage,
                                 config=CFG)
        qc = pmt.Corpus(c, storage=storage, config=CFG)
        si, sv = cc.topk(q, 8, "cosine", probe=None)
        qi, qv = qc.topk(q, 8, "cosine")
        np.testing.assert_array_equal(si, qi)
        np.testing.assert_allclose(sv, qv, rtol=1e-4, atol=1e-5)

    def test_mask_and_delete(self):
        rng = np.random.default_rng(11)
        q, c = blobs(rng, 1500, 12, 16)
        cc = pmt.ClusteredCorpus(c, clusters=8, config=CFG)
        ref = pmt.Corpus(c, config=CFG)
        mask = rng.random(1500) > 0.5
        mi, mv = cc.topk(q, 6, "cosine", probe=None, mask=mask)
        ri, rv = ref.topk(q, 6, "cosine", mask=mask)
        np.testing.assert_array_equal(mi, ri)
        # probed + mask: only allowed ids can appear
        pi, _ = cc.topk(q, 6, "cosine", probe=0.5, mask=mask)
        real = pi[pi < 1500]
        assert mask[real].all()
        # delete composes (and is cached for the unmasked path)
        victims = ri[:, 0]
        assert cc.delete(victims) == len(set(victims.tolist()))
        di, _ = cc.topk(q, 6, "cosine", probe=None)
        assert not np.isin(victims, di).any()
        di2, _ = cc.topk(q, 6, "cosine", probe=None)  # cached-mask path
        np.testing.assert_array_equal(di, di2)

    def test_edge_cases(self):
        rng = np.random.default_rng(12)
        q, c = blobs(rng, 600, 8, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        i0, v0 = cc.topk(q[:0], 5)
        assert i0.shape[0] == 0
        iz, vz = cc.topk(q, 0)
        assert iz.shape == (8, 0)
        ic, _ = cc.topk(q, 10_000)  # k clamps to n
        assert ic.shape == (8, 600)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            cc.topk(q[:, :5], 3)
        with pytest.raises(ValueError, match="Empty series"):
            pmt.ClusteredCorpus(c[:0], config=CFG)
        with pytest.raises(ValueError, match="Unknown storage"):
            pmt.ClusteredCorpus(c, storage="fp8", config=CFG)
        with pytest.raises(ValueError, match="float"):
            pmt.ClusteredCorpus(np.zeros((4, 4), np.int8), config=CFG)

    def test_half_precision_queries(self):
        rng = np.random.default_rng(13)
        q, c = blobs(rng, 900, 10, 16)
        cc = pmt.ClusteredCorpus(c, clusters=6, config=CFG)
        fi, _ = cc.topk(q, 5, "cosine", probe=None)
        hi, _ = cc.topk(q.astype(np.float16), 5, "cosine", probe=None)
        assert recall(hi, fi) > 0.9

    def test_large_k_retile_regime(self):
        """k > 16 flips the kernel to the big-tile query geometry; the
        probe's query-block count must follow.  At k > 16 the exhaustive
        scan runs the gstack selection, whose few-ulp score truncation
        resolves near-ties by LAYOUT position — permuted (clustered) vs
        original (Corpus) order may swap indices within that band, so
        the identity assertion is pair-consistency, not bit equality
        (k <= 16 identity stays exact and is asserted elsewhere)."""
        rng = np.random.default_rng(14)
        q, c = blobs(rng, 2000, 20, 16)
        cc = pmt.ClusteredCorpus(c, clusters=10, config=CFG)
        ref = pmt.Corpus(c, config=CFG)
        ei, ev = cc.topk(q, 24, "cosine", probe=None)
        ri, rv = ref.topk(q, 24, "cosine")
        np.testing.assert_allclose(ev, rv, rtol=3e-5, atol=2e-5)
        mism = np.asarray(ei) != np.asarray(ri)
        assert np.all(np.abs(np.asarray(ev)[mism] - np.asarray(rv)[mism])
                      <= 2e-5 + 3e-5 * np.abs(np.asarray(rv)[mism])), (
            "index mismatch without score tie")
        pi, _ = cc.topk(q, 24, "cosine", probe=0.5)
        assert recall(pi, ri) > 0.8

    def test_results_are_host_owned(self):
        """np results must not alias recyclable jax buffers (the view
        hazard every other surface guards against)."""
        rng = np.random.default_rng(15)
        q, c = blobs(rng, 800, 9, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        i1, v1 = cc.topk(q, 5, "cosine", probe=2)
        i1c, v1c = i1.copy(), v1.copy()
        for _ in range(3):
            cc.topk(rng.standard_normal((9, 16)).astype(np.float32),
                    5, "dot", probe=2)
        np.testing.assert_array_equal(i1, i1c)
        np.testing.assert_array_equal(v1, v1c)


class TestClusteredPersistence:
    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_save_load_roundtrip(self, tmp_path, storage):
        rng = np.random.default_rng(20)
        q, c = blobs(rng, 2000, 12, 24)
        cc = pmt.ClusteredCorpus(c, clusters=10, storage=storage,
                                 config=CFG)
        p = tmp_path / "cc.npz"
        cc.save(p)
        cc2 = pmt.ClusteredCorpus.load(p, config=CFG)
        assert (cc2.n, cc2.dim, cc2.storage, cc2.clusters) == \
            (cc.n, cc.dim, cc.storage, cc.clusters)
        np.testing.assert_array_equal(cc2.layout.perm, cc.layout.perm)
        np.testing.assert_array_equal(cc2.layout.row_pos, cc.layout.row_pos)
        # probed results are bit-identical: same layout, same centroids,
        # same storage-native payload (never requantized)
        for probe in (None, 3):
            i1, v1 = cc.topk(q, 7, "cosine", probe=probe)
            i2, v2 = cc2.topk(q, 7, "cosine", probe=probe)
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_array_equal(v1, v2)

    def test_save_preserves_tombstones(self, tmp_path):
        rng = np.random.default_rng(21)
        q, c = blobs(rng, 900, 8, 16)
        cc = pmt.ClusteredCorpus(c, clusters=6, config=CFG)
        i0, _ = cc.topk(q, 3, "cosine")
        cc.delete(i0[:, 0])
        p = tmp_path / "cc.npz"
        cc.save(p)
        cc2 = pmt.ClusteredCorpus.load(p)
        assert cc2.deleted_count == cc.deleted_count
        i1, _ = cc.topk(q, 3, "cosine")
        i2, _ = cc2.topk(q, 3, "cosine")
        np.testing.assert_array_equal(i1, i2)
        assert not np.isin(i2, i0[:, 0]).any()

    def test_deleted_count_is_property(self):
        rng = np.random.default_rng(22)
        _, c = blobs(rng, 600, 4, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        assert cc.deleted_count == 0
        assert cc.delete([1, 2]) == 2
        assert cc.deleted_count == 2


class TestClusteredAdd:
    @pytest.mark.parametrize("storage", ["f32", "int8"])
    def test_add_matches_rebuilt_corpus(self, storage):
        rng = np.random.default_rng(30)
        q, c = blobs(rng, 1500, 12, 16)
        _, extra = blobs(rng, 400, 1, 16)
        cc = pmt.ClusteredCorpus(c, clusters=8, storage=storage, config=CFG)
        tiles_before = cc.n_tiles
        assert cc.add(extra) == 1900
        assert cc.n_tiles >= tiles_before
        ref = pmt.Corpus(np.concatenate([c, extra]), storage=storage,
                         config=CFG)
        ei, ev = cc.topk(q, 8, "cosine", probe=None)
        ri, rv = ref.topk(q, 8, "cosine")
        np.testing.assert_array_equal(ei, ri)
        np.testing.assert_allclose(ev, rv, rtol=1e-4, atol=1e-5)

    def test_add_overflow_appends_whole_tiles(self):
        rng = np.random.default_rng(31)
        _, c = blobs(rng, 600, 1, 16, n_centers=3)
        cc = pmt.ClusteredCorpus(c, clusters=3, config=CFG)
        lay = cc.layout
        # overflow every cluster: add more rows than total slack
        slack = int((lay.perm < 0).sum())
        _, extra = blobs(rng, slack + 3 * CFG.block_n, 1, 16, n_centers=3)
        cc.add(extra)
        lay2 = cc.layout
        assert lay2.n_padded % CFG.block_n == 0
        assert lay2.n_padded > lay.n_padded
        live = lay2.perm >= 0
        assert np.array_equal(np.sort(lay2.perm[live]), np.arange(cc.n))
        assert np.array_equal(lay2.perm[lay2.row_pos], np.arange(cc.n))
        # every tile still single-cluster: appended tiles carry their
        # cluster id, and row_pos agrees with tile_cluster via assignment
        assert lay2.counts.sum() == cc.n
        assert np.array_equal(
            np.bincount(lay2.tile_cluster, minlength=3) * CFG.block_n,
            (lay2.counts + CFG.block_n - 1)
            // CFG.block_n * CFG.block_n)

    def test_added_rows_probe_to_their_cluster(self):
        rng = np.random.default_rng(32)
        centers = rng.standard_normal((6, 24)) * 10
        c = (centers[np.repeat(np.arange(6), 200)]
             + 0.1 * rng.standard_normal((1200, 24))).astype(np.float32)
        cc = pmt.ClusteredCorpus(c, clusters=6, config=CFG)
        # new rows near center 2; query near center 2 must find them
        extra = (centers[2] + 0.05 * rng.standard_normal((40, 24))
                 ).astype(np.float32)
        cc.add(extra)
        q = (centers[2] + 0.05 * rng.standard_normal((4, 24))
             ).astype(np.float32)
        pi, _ = cc.topk(q, 10, "euclidean", probe=2)
        assert (pi >= 1200).any()
        ri, _ = pmt.Corpus(np.concatenate([c, extra]),
                           config=CFG).topk(q, 10, "euclidean")
        assert recall(pi, ri) > 0.9

    def test_add_then_save_load_and_delete(self, tmp_path):
        rng = np.random.default_rng(33)
        q, c = blobs(rng, 800, 6, 16)
        _, extra = blobs(rng, 100, 1, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        cc.delete([5, 7])
        cc.add(extra)
        assert cc.deleted_count == 2
        p = tmp_path / "cc.npz"
        cc.save(p)
        cc2 = pmt.ClusteredCorpus.load(p)
        i1, v1 = cc.topk(q, 5, "cosine")
        i2, v2 = cc2.topk(q, 5, "cosine")
        np.testing.assert_array_equal(i1, i2)
        assert not np.isin(i1, [5, 7]).any()

    def test_add_validation(self):
        rng = np.random.default_rng(34)
        _, c = blobs(rng, 500, 1, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            cc.add(np.ones((3, 8), np.float32))
        with pytest.raises(ValueError, match="float"):
            cc.add(np.ones((3, 16), np.int32))
        assert cc.add(np.empty((0, 16), np.float32)) == 500


# ---------------------------------------------------------------------------
# mesh composition (fake 8-device CPU mesh)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return pmt.make_mesh(1, 8)


class TestClusteredMesh:
    @pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
    def test_exhaustive_matches_single_device(self, mesh8, metric):
        rng = np.random.default_rng(40)
        q, c = blobs(rng, 4000, 20, 24)
        cm = pmt.ClusteredCorpus(c, clusters=12, mesh=mesh8, config=CFG)
        cs = pmt.ClusteredCorpus(c, clusters=12, config=CFG)
        mi, mv = cm.topk(q, 9, metric)
        si, sv = cs.topk(q, 9, metric)
        # Mesh handles stripe + dead-pad the layout, so the packed group
        # bits differ from the single-device permutation: near-ties
        # within the truncation band may swap (see the exhaustive test).
        assert_topk_equivalent(mi, mv, si, sv, rtol=1e-4, atol=5e-4)

    def test_matmul_matches_oracle(self, mesh8):
        rng = np.random.default_rng(46)
        q, c = blobs(rng, 3000, 7, 24)
        cm = pmt.ClusteredCorpus(c, clusters=10, mesh=mesh8, config=CFG)
        panel = cm.matmul(q)
        assert panel.shape == (7, 3000)
        np.testing.assert_allclose(panel, q @ c.T, rtol=2e-4, atol=2e-3)

    def test_probed_recall_on_blobs(self, mesh8):
        rng = np.random.default_rng(41)
        q, c = blobs(rng, 6000, 32, 32, n_centers=30)
        cm = pmt.ClusteredCorpus(c, clusters=30, mesh=mesh8, config=CFG)
        ri, _ = pmt.Corpus(c, config=CFG).topk(q, 10, "cosine")
        pi, _ = cm.topk(q, 10, "cosine", probe=0.5)
        assert recall(pi, ri) > 0.85
        # probed scores are exact over visited rows
        pi2, pv2 = cm.topk(q, 10, "cosine", probe=0.5)
        np.testing.assert_array_equal(pi, pi2)

    @pytest.mark.parametrize("storage", ["bf16", "int8", "int4"])
    def test_storage_tiers_match_single_device(self, mesh8, storage):
        rng = np.random.default_rng(42)
        q, c = blobs(rng, 3000, 12, 24)
        cm = pmt.ClusteredCorpus(c, clusters=8, storage=storage,
                                 mesh=mesh8, config=CFG)
        cs = pmt.ClusteredCorpus(c, clusters=8, storage=storage,
                                 config=CFG)
        mi, mv = cm.topk(q, 7, "cosine")
        si, sv = cs.topk(q, 7, "cosine")
        np.testing.assert_array_equal(mi, si)
        np.testing.assert_allclose(mv, sv, rtol=1e-4, atol=1e-5)

    def test_mask_delete_and_probe(self, mesh8):
        rng = np.random.default_rng(43)
        q, c = blobs(rng, 2500, 10, 16)
        cm = pmt.ClusteredCorpus(c, clusters=8, mesh=mesh8, config=CFG)
        ref = pmt.Corpus(c, config=CFG)
        mask = rng.random(2500) > 0.4
        mi, _ = cm.topk(q, 5, "cosine", mask=mask)
        ri, _ = ref.topk(q, 5, "cosine", mask=mask)
        np.testing.assert_array_equal(mi, ri)
        victims = mi[:, 0].astype(np.int64)
        cm.delete(victims)
        mi2, _ = cm.topk(q, 5, "cosine", mask=mask)
        assert not np.isin(mi2, victims).any()
        # probed search excludes them too (mask rides the probe path)
        mp, _ = cm.topk(q, 5, "cosine", probe=1, mask=mask)
        assert not np.isin(mp, victims).any()

    def test_save_load_reshard(self, mesh8, tmp_path):
        rng = np.random.default_rng(44)
        q, c = blobs(rng, 2000, 8, 16)
        cs = pmt.ClusteredCorpus(c, clusters=6, storage="int8", config=CFG)
        p = tmp_path / "cc.npz"
        cs.save(p)
        cm = pmt.ClusteredCorpus.load(p, mesh=mesh8, config=CFG)
        i1, v1 = cs.topk(q, 6, "cosine")
        i2, v2 = cm.topk(q, 6, "cosine")
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)
        # and back: mesh-saved loads single-device
        p2 = tmp_path / "cc2.npz"
        cm.save(p2)
        c3 = pmt.ClusteredCorpus.load(p2)
        i3, v3 = c3.topk(q, 6, "cosine")
        np.testing.assert_array_equal(i1, i3)

    def test_add_validates_on_mesh(self, mesh8):
        rng = np.random.default_rng(45)
        _, c = blobs(rng, 900, 1, 16)
        cm = pmt.ClusteredCorpus(c, clusters=4, mesh=mesh8, config=CFG)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            cm.add(np.ones((2, 17), np.float32))

    def test_mesh_probed_large_k_uses_layout_tiles(self, mesh8):
        """The probed mesh path must address each shard at the LAYOUT's
        tile height — tile ids address the corpus at layout granularity,
        and any other tiling reads past the shard or pairs indices with
        the wrong rows."""
        rng = np.random.default_rng(104)
        q, c = blobs(rng, 36864, 8, 32, n_centers=18)
        cm = pmt.ClusteredCorpus(c, clusters=18, mesh=mesh8)
        i, v = cm.topk(q, 32, "dot", probe=0.5)
        assert i.shape == (8, 32)
        real = i != np.iinfo(np.int32).max
        assert real.any()
        s = q.astype(np.float64) @ c.astype(np.float64).T
        for r in range(8):
            got = v[r][real[r]]
            want = s[r, i[r][real[r]].astype(np.int64)]
            # exact-over-visited-rows: garbage tile addressing breaks
            # the (index, score) pairing immediately
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-2)

    def test_large_k_on_mesh_honors_probe(self, mesh8):
        """k above the shard's tile budget: the exhaustive mesh scan
        equals Corpus, and probe= is honored (never ignored) — one tile
        per shard cannot fill k=1100, so the tail comes back as
        sentinels."""
        rng = np.random.default_rng(46)
        q, c = blobs(rng, 9600, 6, 16)
        cfg = SearchConfig(block_q=8, block_n=128)
        cm = pmt.ClusteredCorpus(c, clusters=4, mesh=mesh8, config=cfg)
        ref = pmt.Corpus(c, config=cfg)
        ei, ev = cm.topk(q, 1100, "cosine", probe=None)
        ri, rv = ref.topk(q, 1100, "cosine")
        np.testing.assert_array_equal(ei, ri)
        mi, mv = cm.topk(q, 1100, "cosine", probe=1)
        big = np.iinfo(np.int32).max
        real = mi != big
        assert (real.sum(axis=1) <= 8 * 128).all()
        assert np.isneginf(mv[~real]).all()


class TestClusteredUpdate:
    @pytest.mark.parametrize("storage", ["f32", "int8"])
    def test_update_matches_rebuilt_corpus(self, storage):
        rng = np.random.default_rng(50)
        q, c = blobs(rng, 1800, 10, 16)
        cc = pmt.ClusteredCorpus(c, clusters=8, storage=storage, config=CFG)
        idx = rng.choice(1800, 200, replace=False)
        newrows = blobs(rng, 200, 1, 16)[1]
        cc.update(idx, newrows)
        c2 = c.copy()
        c2[idx] = newrows
        ref = pmt.Corpus(c2, storage=storage, config=CFG)
        ei, ev = cc.topk(q, 8, "cosine", probe=None)
        ri, rv = ref.topk(q, 8, "cosine")
        np.testing.assert_array_equal(ei, ri)
        np.testing.assert_allclose(ev, rv, rtol=1e-4, atol=1e-5)

    def test_update_moves_to_new_cluster_for_probe(self):
        rng = np.random.default_rng(51)
        centers = rng.standard_normal((5, 24)) * 10
        c = (centers[np.repeat(np.arange(5), 300)]
             + 0.1 * rng.standard_normal((1500, 24))).astype(np.float32)
        cc = pmt.ClusteredCorpus(c, clusters=5, config=CFG)
        # move rows 0..19 (blob 0) to blob 3's neighborhood
        moved = (centers[3] + 0.05 * rng.standard_normal((20, 24))
                 ).astype(np.float32)
        cc.update(np.arange(20), moved)
        q = (centers[3] + 0.05 * rng.standard_normal((4, 24))
             ).astype(np.float32)
        # a probe covering blob 3's cluster (300 rows ~ 3 tiles of 128,
        # +1 for update growth) must now see the moved rows; probing the
        # whole OLD cluster of the moved rows must not be needed
        pi, _ = cc.topk(q, 10, "euclidean", probe=4)
        assert (pi < 20).any()

    def test_update_revives_tombstoned_and_refills_slack(self):
        rng = np.random.default_rng(52)
        q, c = blobs(rng, 900, 5, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        n_padded_before = cc.layout.n_padded
        cc.delete([3])
        cc.update(np.array([3]), c[3:4])  # same values, revived
        assert cc.deleted_count == 0
        i1, _ = cc.topk(q, 5, "cosine")
        ri, _ = pmt.Corpus(c, config=CFG).topk(q, 5, "cosine")
        np.testing.assert_array_equal(i1, ri)
        # churn: many updates must not grow the layout unboundedly
        # (vacated slots are refilled as slack)
        for _ in range(5):
            idx = rng.choice(900, 100, replace=False)
            cc.update(idx, c[idx])
        assert cc.layout.n_padded <= n_padded_before + 4 * CFG.block_n
        live = cc.layout.perm >= 0
        assert np.array_equal(np.sort(cc.layout.perm[live]), np.arange(900))

    def test_update_validation(self):
        rng = np.random.default_rng(53)
        _, c = blobs(rng, 500, 1, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            cc.update([0], np.ones((1, 8), np.float32))
        with pytest.raises(ValueError, match="unique"):
            cc.update([1, 1], np.ones((2, 16), np.float32))
        with pytest.raises(ValueError, match="in \\[0, 500\\)"):
            cc.update([500], np.ones((1, 16), np.float32))
        with pytest.raises(ValueError, match="indices for"):
            cc.update([1, 2], np.ones((1, 16), np.float32))
        cc.update(np.empty(0, np.int64), np.empty((0, 16), np.float32))


class TestClusteredArrowSurface:
    def test_topk_arrow_accepts_clustered_handle(self):
        import pyarrow as pa

        rng = np.random.default_rng(60)
        q, c = blobs(rng, 1200, 6, 8)
        cc = pmt.ClusteredCorpus(c, clusters=6, config=CFG)
        qa = pa.array(q.tolist(), type=pa.list_(pa.float32()))
        out = pmt.topk_arrow(qa, cc, k=4, metric="cosine")
        ref_i, ref_v = cc.topk(q, 4, "cosine")
        got = out.to_pylist()
        for r in range(6):
            assert [e["index"] for e in got[r]] == list(ref_i[r])
        # probe= forwards; probed lists are valid structs too
        out_p = pmt.topk_arrow(qa, cc, k=4, probe=2)
        assert len(out_p) == 6

    def test_probe_rejected_without_clustered(self):
        import pyarrow as pa

        rng = np.random.default_rng(61)
        q, c = blobs(rng, 300, 3, 8)
        qa = pa.array(q.tolist(), type=pa.list_(pa.float32()))
        ca = pa.array(c.tolist(), type=pa.list_(pa.float32()))
        with pytest.raises(ValueError, match="probe= requires"):
            pmt.topk_arrow(qa, ca, k=3, probe=2)
        h = pmt.Corpus(c, config=CFG)
        with pytest.raises(ValueError, match="probe= requires"):
            pmt.topk_arrow(qa, h, k=3, probe=2)

    def test_matmul_arrow_accepts_clustered_handle(self):
        import pyarrow as pa

        rng = np.random.default_rng(62)
        q, c = blobs(rng, 700, 5, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        qa = pa.array(q.tolist(), type=pa.list_(pa.float32()))
        out = pmt.matmul_arrow(qa, cc)
        panel = np.array(out.to_pylist(), dtype=np.float32)
        np.testing.assert_allclose(panel, q @ c.T, rtol=2e-4, atol=2e-3)
        # flatten mode: row-major flat column
        flat = pmt.matmul_arrow(qa, cc, flatten=True)
        np.testing.assert_allclose(
            np.asarray(flat.to_numpy(zero_copy_only=False)),
            panel.reshape(-1), rtol=1e-6)
        # empty-left typed fast return
        empty = pa.array([], type=pa.list_(pa.float32()))
        assert len(pmt.matmul_arrow(empty, cc)) == 0
        # config= is the handle's job, same contract as Corpus
        with pytest.raises(ValueError, match="config= has no effect"):
            pmt.matmul_arrow(qa, cc, config=CFG)


class TestQueryRouting:
    """route=True groups a diverse probed batch by best cluster so the
    per-block tile-union budget isn't diluted; results return in caller
    order.  Measured on this shape: recall .25 -> .77 at probe=0.2."""

    def _setup(self, seed=5, nq=600):
        rng = np.random.default_rng(seed)
        nb, dim = 30, 32
        centers = rng.standard_normal((nb, dim)).astype(np.float32) * 5.0
        c = (centers[rng.integers(0, nb, 20000)]
             + rng.standard_normal((20000, dim))).astype(np.float32)
        q = (centers[rng.integers(0, nb, nq)]
             + rng.standard_normal((nq, dim))).astype(np.float32)
        return q, c, nb

    def test_routing_recovers_diluted_recall(self):
        q, c, nb = self._setup()
        cc = pmt.ClusteredCorpus(c, clusters=nb, config=CFG)
        ei, _ = cc.topk(q, 10)
        iu, _ = cc.topk(q, 10, probe=0.2, route=False)
        ir, _ = cc.topk(q, 10, probe=0.2, route=True)
        ru, rr = recall(iu, ei), recall(ir, ei)
        assert rr > ru + 0.15, (ru, rr)

    def test_routed_results_map_back_to_callers_rows(self):
        # self-queries: with a generous probe every query must find
        # ITSELF first — any permutation bug misaligns rows
        rng = np.random.default_rng(6)
        q, c, nb = self._setup(seed=6)
        cc = pmt.ClusteredCorpus(c, clusters=nb, config=CFG)
        sel = rng.choice(20000, 500, replace=False)
        i, v = cc.topk(c[sel], 1, probe=0.5, route=True)
        hit = i[:, 0] == sel.astype(np.uint32)
        assert hit.mean() > 0.95, hit.mean()  # probe misses allowed, few

    def test_routing_composes_with_mask_and_mesh(self, mesh8):
        q, c, nb = self._setup(seed=7, nq=520)
        cm = pmt.ClusteredCorpus(c, clusters=nb, mesh=mesh8, config=CFG)
        mask = np.ones(20000, bool)
        ei, _ = cm.topk(q, 5)
        band = ei[:, 0].astype(np.int64)
        mask[band] = False  # ban every top hit
        ir, _ = cm.topk(q, 5, probe=0.4, mask=mask, route=True)
        real = ir != np.iinfo(np.int32).max
        assert not np.isin(ir[real].astype(np.int64), band).any()

    def test_route_false_single_block_identical(self):
        # a single-block batch never routes: identical results either way
        q, c, nb = self._setup(seed=8, nq=8)
        cc = pmt.ClusteredCorpus(c, clusters=nb, config=CFG)
        i1, v1 = cc.topk(q, 5, probe=0.3, route=True)
        i2, v2 = cc.topk(q, 5, probe=0.3, route=False)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)


class TestClusteredMeshMutation:
    """Mesh add (host gather + place + re-shard) and mesh update
    (in-place sharded scatter at the rows' permuted slots) — both
    storage-native, results matching the single-device handle."""

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_mesh_add_matches_single_device(self, mesh8, storage):
        rng = np.random.default_rng(96)
        q, c = blobs(rng, 1500, 8, 16)
        more = blobs(rng, 300, 1, 16)[1]
        cm = pmt.ClusteredCorpus(c, clusters=8, storage=storage,
                                 mesh=mesh8, config=CFG)
        cs = pmt.ClusteredCorpus(c, clusters=8, storage=storage,
                                 config=CFG)
        assert cm.add(more) == 1800
        assert cs.add(more) == 1800
        assert cm.drift == pytest.approx(300 / 1800)
        mi, mv = cm.topk(q, 6)
        si, sv = cs.topk(q, 6)
        np.testing.assert_array_equal(mi, si)
        np.testing.assert_allclose(mv, sv, rtol=1e-4, atol=1e-5)
        # new rows are findable (probed too — they joined real clusters)
        ni, _ = cm.topk(more[:4], 1)
        assert (ni[:, 0] >= 1500).all()

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_mesh_update_matches_single_device(self, mesh8, storage):
        rng = np.random.default_rng(97)
        q, c = blobs(rng, 2000, 10, 16)
        cm = pmt.ClusteredCorpus(c, clusters=8, storage=storage,
                                 mesh=mesh8, config=CFG)
        cs = pmt.ClusteredCorpus(c, clusters=8, storage=storage,
                                 config=CFG)
        cm.topk(q, 5)  # build prepared forms BEFORE the patch-in-place
        idx = np.array([0, 7, 1999, 512])
        new = blobs(rng, 4, 1, 16)[1]
        cm.update(idx, new)
        cs.update(idx, new)
        assert cm.drift == cs.drift == pytest.approx(4 / 2000)
        mi, mv = cm.topk(q, 5)
        si, sv = cs.topk(q, 5)
        np.testing.assert_array_equal(mi, si)
        np.testing.assert_allclose(mv, sv, rtol=1e-4, atol=1e-5)
        # the updated values serve exactly (self-query hits itself)
        ui, _ = cm.topk(new, 1)
        np.testing.assert_array_equal(ui[:, 0], idx.astype(np.uint32))

    def test_mesh_update_revives_tombstone(self, mesh8):
        rng = np.random.default_rng(98)
        q, c = blobs(rng, 1200, 5, 16)
        cm = pmt.ClusteredCorpus(c, clusters=6, mesh=mesh8, config=CFG)
        cm.delete([11])
        i, _ = cm.topk(c[11][None], 1)
        assert i[0, 0] != 11
        cm.update([11], c[11][None])
        i2, _ = cm.topk(c[11][None], 1)
        assert i2[0, 0] == 11

    def test_mesh_add_keeps_probed_recall(self, mesh8):
        """A tile-growing mesh add must not degrade probed recall on the
        resident data: align unstripes to canonical order before
        re-striping (stripe-of-stripe would re-concentrate each
        cluster's tiles on one shard — the collapse striping prevents)."""
        rng = np.random.default_rng(100)
        q, c = blobs(rng, 4000, 30, 32, n_centers=16)
        cm = pmt.ClusteredCorpus(c, clusters=16, mesh=mesh8, config=CFG)
        ei0, _ = cm.topk(q, 10)
        r0 = recall(cm.topk(q, 10, probe=0.5)[0], ei0)
        # same-distribution rows overflow cluster slack -> tiles append
        more = (c[rng.integers(0, 4000, 1200)]
                + 0.01 * rng.standard_normal((1200, 32))).astype(np.float32)
        tiles_before = cm.layout.n_tiles
        cm.add(more)
        assert cm.layout.n_tiles > tiles_before  # growth actually happened
        ei1, _ = cm.topk(q, 10)
        r1 = recall(cm.topk(q, 10, probe=0.5)[0], ei1)
        assert r1 > max(0.85, r0 - 0.1), (r0, r1)

    def test_mesh_slack_only_add_is_in_place(self, mesh8):
        """An add that fits existing slack must not re-shard: the padded
        height, sharded buffers, and layout object identity (modulo the
        new rows) stay, and the new rows serve immediately."""
        rng = np.random.default_rng(101)
        q, c = blobs(rng, 2000, 5, 16)
        cm = pmt.ClusteredCorpus(c, clusters=8, mesh=mesh8, config=CFG)
        data_before = cm._sharded.data
        slack = int((cm.layout.perm < 0).sum())
        m = min(8, slack)
        assert m > 0
        more = (c[:m] + 0.1).astype(np.float32)
        cm.add(more)
        assert cm.layout.perm.shape[0] == data_before.shape[0]
        ni, _ = cm.topk(more, 1)
        np.testing.assert_array_equal(
            ni[:, 0], np.arange(2000, 2000 + m, dtype=np.uint32))

    def test_mesh_save_load_probed_identical(self, mesh8, tmp_path):
        """Loading with the same mesh must not restripe: layout and
        probed results are bit-identical to the saved handle's."""
        rng = np.random.default_rng(102)
        q, c = blobs(rng, 2500, 8, 16)
        cm = pmt.ClusteredCorpus(c, clusters=10, mesh=mesh8, config=CFG)
        p = tmp_path / "striped.npz"
        cm.save(p)
        c2 = pmt.ClusteredCorpus.load(p, mesh=mesh8, config=CFG)
        np.testing.assert_array_equal(c2.layout.perm, cm.layout.perm)
        i1, v1 = cm.topk(q, 5, probe=0.4)
        i2, v2 = c2.topk(q, 5, probe=0.4)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)

    def test_mesh_add_does_not_leak_dead_tiles(self, mesh8):
        """Repeated add-overflow cycles must not accumulate dead
        alignment tiles: align drops them from the canonical order
        before re-striping, so the dead count stays < n_shards."""
        rng = np.random.default_rng(103)
        q, c = blobs(rng, 1800, 6, 16)
        cm = pmt.ClusteredCorpus(c, clusters=6, mesh=mesh8, config=CFG)
        shadow = c
        for i in range(4):
            batch = (c[rng.integers(0, 1800, 400)]
                     + 0.01 * rng.standard_normal((400, 16))
                     ).astype(np.float32)
            cm.add(batch)
            shadow = np.vstack([shadow, batch])
            dead = int((cm.layout.tile_cluster == -1).sum())
            assert dead < 8, (i, dead)
        # still correct after the cycles
        i1, v1 = cm.topk(q, 5)
        i2, v2 = pmt.Corpus(shadow, config=CFG).topk(q, 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)

    def test_mesh_add_then_rebuild_recovers_probe(self, mesh8):
        rng = np.random.default_rng(99)
        q, c = blobs(rng, 2500, 20, 32, n_centers=12)
        cm = pmt.ClusteredCorpus(c, clusters=12, mesh=mesh8, config=CFG)
        shift = np.full((1, 32), 25.0, np.float32)
        centers = shift + rng.standard_normal((6, 32)) * 5.0
        drift = (centers[rng.integers(0, 6, 1500)]
                 + rng.standard_normal((1500, 32))).astype(np.float32)
        cm.add(drift)
        qd = (centers[rng.integers(0, 6, 30)]
              + rng.standard_normal((30, 32))).astype(np.float32)
        ei, _ = cm.topk(qd, 8)
        r_before = recall(cm.topk(qd, 8, probe=0.25)[0], ei)
        cm.rebuild()
        assert cm.drift == 0.0
        r_after = recall(cm.topk(qd, 8, probe=0.25)[0], ei)
        assert r_after > max(r_before, 0.9), (r_before, r_after)


class TestClusteredRebuild:
    """rebuild(): re-fit centroids + re-lay out, storage-native.  The
    exhaustive scan must be invariant (codes are permuted, never
    requantized); the probe's recall must RECOVER after drift."""

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_exhaustive_invariant(self, storage):
        rng = np.random.default_rng(90)
        q, c = blobs(rng, 2000, 12, 16)
        cc = pmt.ClusteredCorpus(c, clusters=8, storage=storage, config=CFG)
        before = {m: cc.topk(q, 5, m) for m in ("cosine", "dot",
                                                "euclidean")}
        assert cc.rebuild(clusters=5, seed=7) is cc
        assert cc.clusters == 5
        for m, (i0, v0) in before.items():
            i1, v1 = cc.topk(q, 5, m)
            np.testing.assert_array_equal(i1, i0, err_msg=m)
            np.testing.assert_allclose(v1, v0, rtol=1e-6, atol=1e-7,
                                       err_msg=m)

    def test_recall_recovers_after_drift(self):
        rng = np.random.default_rng(91)
        q, c = blobs(rng, 3000, 40, 32, n_centers=25)
        cc = pmt.ClusteredCorpus(c, clusters=25, config=CFG)
        # drift: ten new distinct blobs the original centroids know
        # nothing about (distinct, so top-k membership is well-defined —
        # near-duplicate rows would make recall meaningless under ties)
        shift = np.full((1, 32), 30.0, np.float32)
        new_centers = shift + rng.standard_normal((10, 32)) * 6.0
        drift = (new_centers[rng.integers(0, 10, 2500)]
                 + rng.standard_normal((2500, 32))).astype(np.float32)
        cc.add(drift)
        qd = (new_centers[rng.integers(0, 10, 40)]
              + rng.standard_normal((40, 32))).astype(np.float32)
        ei, ev = cc.topk(qd, 10)
        pi_before, _ = cc.topk(qd, 10, probe=0.25)
        r_before = recall(pi_before, ei)
        cc.rebuild()
        ei2, ev2 = cc.topk(qd, 10)
        # exhaustive scan invariant up to exact-score ties (the dense
        # drift mode produces bit-equal f32 cosines; tie order follows
        # the permuted layout, like the reference's unstable quickselect)
        mism = ei2 != ei
        if mism.any():
            r, col = np.nonzero(mism)
            np.testing.assert_array_equal(ev2[r, col], ev[r, col])
        pi_after, _ = cc.topk(qd, 10, probe=0.25)
        r_after = recall(pi_after, ei)
        assert r_after > max(r_before, 0.9), (r_before, r_after)

    def test_tombstones_and_ids_stable(self):
        rng = np.random.default_rng(92)
        q, c = blobs(rng, 800, 6, 16)
        cc = pmt.ClusteredCorpus(c, clusters=6, config=CFG)
        cc.delete([3, 4, 5])
        cc.rebuild(seed=5)
        assert cc.deleted_count == 3
        i, _ = cc.topk(q, 6)
        assert not np.isin(i, [3, 4, 5]).any()
        # a revive still works against the new layout
        cc.update([4], c[4][None])
        i2, _ = cc.topk(c[4][None], 1)
        assert i2[0, 0] == 4

    @pytest.mark.parametrize("storage", ["f32", "int8"])
    def test_rebuild_on_mesh(self, mesh8, storage):
        rng = np.random.default_rng(93)
        q, c = blobs(rng, 2500, 10, 16)
        cm = pmt.ClusteredCorpus(c, clusters=9, storage=storage,
                                 mesh=mesh8, config=CFG)
        i0, v0 = cm.topk(q, 5)
        cm.rebuild(clusters=6, seed=4)
        i1, v1 = cm.topk(q, 5)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(v1, v0, rtol=1e-6, atol=1e-7)
        # probed search still runs on the new layout
        pi, _ = cm.topk(q, 5, probe=0.5)
        assert pi.shape == (10, 5)

    def test_drift_tracks_adds_updates_resets(self, tmp_path):
        rng = np.random.default_rng(95)
        q, c = blobs(rng, 300, 4, 16)
        cc = pmt.ClusteredCorpus(c, clusters=4, config=CFG)
        assert cc.drift == 0.0
        cc.add(rng.standard_normal((100, 16)).astype(np.float32))
        assert cc.drift == pytest.approx(100 / 400)
        cc.update([0, 1], c[:2])
        assert cc.drift == pytest.approx(102 / 400)
        # persists through save/load (the fit is as stale as it was)
        p = tmp_path / "drift.npz"
        cc.save(p)
        cc2 = pmt.ClusteredCorpus.load(p, config=CFG)
        assert cc2.drift == pytest.approx(102 / 400)
        # a re-fit resets it
        cc2.rebuild(seed=1)
        assert cc2.drift == 0.0

    def test_rebuild_then_add_composes(self):
        rng = np.random.default_rng(94)
        q, c = blobs(rng, 900, 5, 16)
        cc = pmt.ClusteredCorpus(c, clusters=5, config=CFG)
        cc.rebuild(seed=3)
        more = rng.standard_normal((80, 16)).astype(np.float32)
        assert cc.add(more) == 980
        full = np.vstack([c, more])
        ref = pmt.Corpus(full, config=CFG)
        i1, v1 = cc.topk(q, 5)
        i2, v2 = ref.topk(q, 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# reserve_tiles: in-place growth reserve (VERDICT r01 item 8)
# ---------------------------------------------------------------------------


class TestReserveTiles:
    def test_overflow_claims_reserve_without_growth(self):
        rng = np.random.default_rng(95)
        q, c = blobs(rng, 600, 8, 16, n_centers=3)
        cc = pmt.ClusteredCorpus(c, clusters=3, config=CFG,
                                 reserve_tiles=2)
        lay = cc.layout
        assert int((lay.tile_cluster == -1).sum()) == 2
        # overflow ONE cluster's slack by a few rows (targeted: clones of
        # c[0] assign to c[0]'s cluster): the add must claim a reserve
        # tile, not grow the padded layout
        cl = int(assign_rows(c[:1], np.asarray(cc.centroids))[0])
        slack_cl = int((-lay.counts[cl]) % CFG.block_n)
        extra = (c[0] + 1e-3 * rng.standard_normal(
            (slack_cl + 5, 16))).astype(np.float32)
        n0 = lay.n_padded
        cc.add(extra)
        assert cc.layout.n_padded == n0  # no growth
        assert int((cc.layout.tile_cluster == -1).sum()) < 2  # claimed
        ref = pmt.Corpus(np.vstack([c, extra]), config=CFG)
        i1, v1 = cc.topk(q, 6)
        i2, v2 = ref.topk(q, 6)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)

    def test_reserve_exhausted_appends(self):
        rng = np.random.default_rng(96)
        q, c = blobs(rng, 400, 5, 16, n_centers=2)
        cc = pmt.ClusteredCorpus(c, clusters=2, config=CFG,
                                 reserve_tiles=1)
        # far more rows than reserve + slack: must append and stay exact
        extra = rng.standard_normal((5 * CFG.block_n, 16)).astype(
            np.float32)
        n0 = cc.layout.n_padded
        cc.add(extra)
        assert cc.layout.n_padded > n0
        ref = pmt.Corpus(np.vstack([c, extra]), config=CFG)
        i1, v1 = cc.topk(q, 6)
        i2, v2 = ref.topk(q, 6)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)

    def test_save_load_preserves_reserve(self, tmp_path):
        rng = np.random.default_rng(97)
        _, c = blobs(rng, 500, 1, 16)
        cc = pmt.ClusteredCorpus(c, clusters=3, config=CFG,
                                 reserve_tiles=2)
        p = tmp_path / "cc.npz"
        cc.save(p)
        cc2 = pmt.ClusteredCorpus.load(p, config=CFG)
        assert cc2._reserve_tiles == 2
        assert int((cc2.layout.tile_cluster == -1).sum()) == 2

    def test_validation(self):
        rng = np.random.default_rng(98)
        _, c = blobs(rng, 300, 1, 16)
        with pytest.raises(ValueError, match="reserve_tiles"):
            pmt.ClusteredCorpus(c, clusters=2, config=CFG,
                                reserve_tiles=-1)


class TestReserveTilesMesh:
    def test_in_reserve_add_never_reinstalls(self, mesh8):
        """The VERDICT item-8 gate: an add of <= 1 tile's rows on a mesh
        handle with reserve must move O(tile) bytes — the full-corpus
        gather + re-shard paths are instrumented to fail if touched."""
        rng = np.random.default_rng(99)
        centers = rng.standard_normal((3, 16)) * 10
        c = (centers[np.repeat(np.arange(3), 300)]
             + 0.1 * rng.standard_normal((900, 16))).astype(np.float32)
        q = (centers[rng.integers(0, 3, 12)]
             + 0.1 * rng.standard_normal((12, 16))).astype(np.float32)
        cm = pmt.ClusteredCorpus(c, clusters=3, mesh=mesh8, config=CFG,
                                 reserve_tiles=8)
        lay = cm.layout
        assert int((lay.tile_cluster == -1).sum()) >= 8

        def boom(*a, **kw):
            raise AssertionError("full-corpus transfer on in-reserve add")

        cm._gather_native_host = boom
        cm._install_payload = boom
        # overflow one cluster's slack by a few rows: must claim reserve
        cl = int(assign_rows(
            np.asarray(centers[:1], np.float32),
            np.asarray(cm.centroids))[0])
        slack_cl = int((-lay.counts[cl]) % CFG.block_n)
        extra = (centers[0] + 0.1 * rng.standard_normal(
            (slack_cl + 7, 16))).astype(np.float32)
        n0 = lay.n_padded
        cm.add(extra)
        assert cm.layout.n_padded == n0
        ref = pmt.Corpus(np.vstack([c, extra]), config=CFG)
        i1, v1 = cm.topk(q, 6)
        i2, v2 = ref.topk(q, 6)
        # Tight blobs put same-cluster neighbors within ulps of each
        # other in cosine; the permuted/striped layouts pack different
        # group bits, so such near-ties may come back rotated — demand
        # pair-consistency, not bit-equality (same contract as the
        # exhaustive tests above).
        assert_topk_equivalent(i1, v1, i2, v2, rtol=1e-4, atol=1e-5)
        # probed search sees the claimed tiles (tc_sharded refreshed):
        # queries near center 0 find the added rows under a tight probe
        pi, _ = cm.topk(q[:4], 8, "euclidean", probe=3)
        ri, _ = ref.topk(q[:4], 8, "euclidean")
        assert recall(pi, ri) > 0.8


def test_probed_bigk_raised_carry():
    """128 < k <= 1024 on the probed path (round 4): the scalar-prefetch
    tile walk runs extract with the auto-raised carry width.  Exhaustive
    matches Corpus; a tight probe returns exact results over the visited
    tiles with sentinels for slots it cannot fill."""
    rng = np.random.default_rng(300)
    q, c = blobs(rng, 4000, 8, 24)
    cc = pmt.ClusteredCorpus(c, clusters=8, config=CFG)
    ref = pmt.Corpus(c, config=CFG)
    k = 200
    ei, ev = cc.topk(q, k, "cosine", probe=None)
    ri, rv = ref.topk(q, k, "cosine")
    assert_topk_equivalent(ei, ev, ri, rv, rtol=1e-4, atol=5e-4)
    # tight probe: one tile per block = at most CFG.block_n=128 real
    # rows per query; the rest of the k slots must carry sentinels
    pi, pv = cc.topk(q, k, "cosine", probe=1)
    assert pi.shape == (q.shape[0], k)
    big = np.iinfo(np.int32).max
    assert (pi[:, CFG.block_n:] == big).all()
    assert np.isneginf(pv[:, CFG.block_n:]).all()
    # the filled slots are exact over the visited tiles: every returned
    # real (index, score) pair appears identically in the exhaustive run
    for r in range(q.shape[0]):
        real = pi[r] != big
        returned = dict(zip(pi[r][real].tolist(), pv[r][real].tolist()))
        full = dict(zip(ri[r].tolist(), rv[r].tolist()))
        for idx_, v_ in returned.items():
            if idx_ in full:
                assert abs(full[idx_] - v_) <= 5e-4


def test_mesh_probed_bigk(mesh8):
    """128 < k <= 1024 on the MESH probed path: per-shard raised-carry
    extract over each shard's tile list + the candidate merge."""
    rng = np.random.default_rng(301)
    q, c = blobs(rng, 6000, 6, 24)
    cm = pmt.ClusteredCorpus(c, clusters=8, mesh=mesh8, config=CFG)
    cs = pmt.ClusteredCorpus(c, clusters=8, config=CFG)
    k = 160
    mi, mv = cm.topk(q, k, "cosine")          # exhaustive on the mesh
    si, sv = cs.topk(q, k, "cosine")
    assert_topk_equivalent(mi, mv, si, sv, rtol=1e-4, atol=5e-4)
    # probed on the mesh: generous per-shard budget -> high recall vs
    # the single-device exhaustive truth
    pi, _ = cm.topk(q, k, "cosine", probe=0.8)
    hits = np.mean([len(set(pi[r].tolist()) & set(si[r].tolist())) / k
                    for r in range(q.shape[0])])
    assert hits > 0.9, hits
