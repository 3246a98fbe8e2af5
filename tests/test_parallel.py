"""Distributed search over a fake 8-device CPU mesh (SURVEY.md §4 tier (b)).

Exercises corpus sharding, global-index offsets, padding masks, and the
candidate-merge re-select — all deterministically, without a cluster.
"""

import numpy as np
import pytest

import polars_matmul_tpu as pmt
from polars_matmul_tpu.ops import topk_search

from conftest import assert_topk_equivalent


@pytest.fixture(scope="module")
def mesh8():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return pmt.make_mesh(1, 8)


@pytest.fixture(scope="module")
def mesh2x4():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return pmt.make_mesh(2, 4)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_distributed_topk_matches_single_device(qc_f32, mesh8, metric):
    q, c = qc_f32  # N=203: not divisible by 8 -> exercises padding mask
    import jax.numpy as jnp

    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    assert sharded.n_true == c.shape[0]
    v1, i1 = pmt.distributed_topk(jnp.asarray(q), sharded, 10, metric, mesh8)
    v0, i0 = topk_search(q, c, 10, metric)
    assert_topk_equivalent(
        np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
    )


def test_distributed_topk_k_exceeds_shard(mesh8):
    """k larger than one shard's row count: per-shard k_local clamps."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    c = rng.standard_normal((24, 16)).astype(np.float32)  # 3 rows/shard
    import jax.numpy as jnp

    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    v1, i1 = pmt.distributed_topk(jnp.asarray(q), sharded, 10, "cosine", mesh8)
    v0, i0 = topk_search(q, c, 10, "cosine")
    assert_topk_equivalent(
        np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
    )


def test_distributed_matmul(qc_f32, mesh8):
    q, c = qc_f32
    import jax.numpy as jnp

    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    out = np.asarray(pmt.distributed_matmul(jnp.asarray(q), sharded, mesh8))
    np.testing.assert_allclose(out, q @ c.T, rtol=1e-5, atol=1e-5)


def test_data_and_corpus_sharding(mesh2x4):
    """2-D mesh: queries sharded over 'data', corpus over 'corpus'."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    c = rng.standard_normal((100, 32)).astype(np.float32)
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = pmt.shard_corpus(jnp.asarray(c), mesh2x4)
    qj = jax.device_put(
        jnp.asarray(q), NamedSharding(mesh2x4, P("data", None))
    )
    v1, i1 = pmt.distributed_topk(qj, sharded, 10, "cosine", mesh2x4)
    v0, i0 = topk_search(q, c, 10, "cosine")
    assert_topk_equivalent(
        np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
    )


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_ring_merge_matches_single_device(qc_f32, mesh8, metric):
    """ppermute ring merge == allgather merge == single-device result."""
    from polars_matmul_tpu.config import SearchConfig

    q, c = qc_f32
    import jax.numpy as jnp

    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    cfg = SearchConfig(merge="ring")
    v1, i1 = pmt.distributed_topk(jnp.asarray(q), sharded, 10, metric, mesh8,
                                  cfg)
    v0, i0 = topk_search(q, c, 10, metric)
    assert_topk_equivalent(
        np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
    )


def test_ring_merge_cross_shard_ties(mesh8):
    """Duplicated corpus rows across shards: exact index parity under ties
    requires the (score, index) 2-key merge, not positional tie-break."""
    from polars_matmul_tpu.config import SearchConfig

    rng = np.random.default_rng(5)
    base = rng.standard_normal((13, 16)).astype(np.float32)
    cdup = np.concatenate([base] * 8)
    import jax.numpy as jnp

    sharded = pmt.shard_corpus(jnp.asarray(cdup), mesh8)
    cfg = SearchConfig(merge="ring")
    v1, i1 = pmt.distributed_topk(
        jnp.asarray(base[:3]), sharded, 16, "dot", mesh8, cfg
    )
    v0, i0 = topk_search(base[:3], cdup, 16, "dot")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))


def test_corpus_handle_with_mesh(mesh8):
    rng = np.random.default_rng(13)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((50, 16)).astype(np.float32)
    corpus = pmt.Corpus(c, mesh=mesh8)
    idx, scores = corpus.topk(q, 5)
    i0, s0 = pmt.topk(q, c, 5)
    assert_topk_equivalent(idx, scores, i0, s0)
    assert idx.dtype == np.uint32 and scores.dtype == np.float64


def test_corpus_handle_matmul_with_mesh(mesh8):
    rng = np.random.default_rng(17)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((50, 16)).astype(np.float32)
    corpus = pmt.Corpus(c, mesh=mesh8)
    out = corpus.matmul(q)
    np.testing.assert_allclose(out, q @ c.T, rtol=1e-5, atol=1e-5)


def test_distributed_topk_pad_rows_cannot_evict_candidates(mesh8):
    """Global zero-pad rows join the last shard's local selection; with
    k_local == shard size they could evict real (negative-score) rows
    before the post-mask.  All-negative dot scores expose it."""
    rng = np.random.default_rng(21)
    import jax.numpy as jnp

    q = rng.standard_normal((4, 8)).astype(np.float32)
    # 27 rows over 8 shards -> padded to 32 with 5 zero rows in shard 7
    c = -np.abs(rng.standard_normal((27, 8))).astype(np.float32)
    q = -np.abs(q)  # all dot scores strictly negative; zero rows score 0
    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    for merge in ("allgather", "ring"):
        cfg = pmt.SearchConfig(merge=merge)
        v1, i1 = pmt.distributed_topk(jnp.asarray(q), sharded, 4, "dot",
                                      mesh8, cfg)
        v0, i0 = topk_search(q, c, 4, "dot")
        assert_topk_equivalent(
            np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
        )


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_ring_merge_query_pipelining(mesh8, pipeline):
    """The chunked (pipelined) ring merge must agree with the oracle for
    any chunk count, including chunk sizes that do not divide m."""
    rng = np.random.default_rng(31)
    import jax.numpy as jnp

    q = rng.standard_normal((7, 24)).astype(np.float32)
    c = rng.standard_normal((150, 24)).astype(np.float32)
    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    cfg = pmt.SearchConfig(merge="ring", ring_pipeline=pipeline)
    v1, i1 = pmt.distributed_topk(jnp.asarray(q), sharded, 6, "cosine",
                                  mesh8, cfg)
    v0, i0 = topk_search(q, c, 6, "cosine")
    assert_topk_equivalent(
        np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
    )


def test_distributed_topk_masked(mesh8):
    """Filtered search across shards: mask shards along the corpus axis."""
    rng = np.random.default_rng(51)
    import jax.numpy as jnp

    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((100, 16)).astype(np.float32)
    mask = rng.random(100) < 0.4
    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    v1, i1 = pmt.distributed_topk(jnp.asarray(q), sharded, 5, "cosine",
                                  mesh8, mask=mask)
    v0, i0 = topk_search(q, c, 5, "cosine",
                         mask=jnp.asarray(mask))
    assert_topk_equivalent(
        np.asarray(i1), np.asarray(v1), np.asarray(i0), np.asarray(v0)
    )
    assert mask[np.asarray(i1).reshape(-1)].all()


def test_distributed_masked_fewer_matches_than_k(mesh8):
    """A masked shard with fewer matches than k_local emits sentinel
    indices; the shard offset must not be added to them (int32 overflow
    made negative sentinels win tie sorts)."""
    rng = np.random.default_rng(71)
    import jax.numpy as jnp

    q = rng.standard_normal((3, 8)).astype(np.float32)
    c = rng.standard_normal((24, 8)).astype(np.float32)
    mask = np.zeros(24, bool)
    mask[7] = True  # a single matching row
    sharded = pmt.shard_corpus(jnp.asarray(c), mesh8)
    for merge in ("allgather", "ring"):
        cfg = pmt.SearchConfig(merge=merge)
        v, i = pmt.distributed_topk(jnp.asarray(q), sharded, 4, "dot",
                                    mesh8, cfg, mask=mask)
        i = np.asarray(i)
        v = np.asarray(v)
        assert (i[:, 0] == 7).all(), merge
        assert (i[:, 1:] >= 24).all(), merge   # sentinels, not negatives
        assert np.isneginf(v[:, 1:]).all(), merge


def test_sharded_chunked_prep_matches_oneshot(mesh8):
    """Sharded chunked prep (big-shard path) must match one-shot prep."""
    rng = np.random.default_rng(81)
    import jax.numpy as jnp

    q = rng.standard_normal((5, 24)).astype(np.float32)
    c = rng.standard_normal((333, 24)).astype(np.float32)
    big = pmt.shard_corpus(jnp.asarray(c), mesh8)
    small_cfg = pmt.SearchConfig(prep_chunk_bytes=1 << 12)  # force chunking
    small = pmt.shard_corpus(jnp.asarray(c), mesh8, small_cfg)
    v1, i1 = pmt.distributed_topk(jnp.asarray(q), big, 7, "cosine", mesh8)
    v2, i2 = pmt.distributed_topk(jnp.asarray(q), small, 7, "cosine",
                                  mesh8, small_cfg)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    # euclid path through chunked prep too
    v3, i3 = pmt.distributed_topk(jnp.asarray(q), small, 4, "euclidean",
                                  mesh8, small_cfg)
    v0, i0 = topk_search(q, c, 4, "euclidean")
    assert_topk_equivalent(np.asarray(i3), np.asarray(v3),
                           np.asarray(i0), np.asarray(v0))


class TestShardedBf16Storage:
    """Corpus(storage="bf16", mesh=...): bf16 shards, bf16c kernel mode."""

    def test_matches_quantized_oracle(self, mesh8):
        import ml_dtypes

        rng = np.random.default_rng(91)
        q = rng.standard_normal((10, 48)).astype(np.float32)
        c = rng.standard_normal((333, 48)).astype(np.float32)
        h = pmt.Corpus(c, storage="bf16", mesh=mesh8)
        i1, v1 = h.topk(q, 6, "cosine")
        cq = c.astype(ml_dtypes.bfloat16).astype(np.float32)
        i0, v0 = pmt.topk(q, cq, 6, "cosine")
        agree = (i1 == i0).mean()
        assert agree > 0.9, agree
        np.testing.assert_allclose(v1, v0, rtol=5e-2, atol=1e-2)
        # shards are genuinely bfloat16, and so is the per-shard prep
        assert str(h._device.data.dtype) == "bfloat16"
        (cp, _), = [v for v in h._device._prepared.values()]
        assert str(cp.dtype) == "bfloat16"

    def test_ring_merge_and_mask(self, mesh8):
        rng = np.random.default_rng(92)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        mask = rng.random(200) < 0.4
        mask[:8] = True
        h = pmt.Corpus(c, storage="bf16", mesh=mesh8,
                       config=pmt.SearchConfig(merge="ring"))
        i, v = h.topk(q, 5, "dot", mask=mask)
        assert mask[i.reshape(-1)].all()

    def test_fallback_path_upcasts_per_shard(self, mesh8):
        """Large shard-local k (1100) on bf16 shards is served by the
        bf16c scan from the stored shards and ranks the bf16 values."""
        import ml_dtypes

        rng = np.random.default_rng(93)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((9600, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="bf16", mesh=mesh8)
        i, v = h.topk(q, 1100, "cosine")  # k_local=1100 > 1024
        assert i.shape == (4, 1100)
        cq = c.astype(ml_dtypes.bfloat16).astype(np.float32)
        i0, v0 = pmt.topk(q, cq, 1100, "cosine")
        assert (i == i0).mean() > 0.9

    def test_matmul_upcasts_per_shard(self, mesh8):
        import ml_dtypes

        rng = np.random.default_rng(94)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((64, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="bf16", mesh=mesh8)
        out = h.matmul(q)
        assert out.dtype == np.float32
        cq = c.astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_allclose(out, q @ cq.T, rtol=1e-5, atol=1e-5)


class TestShardedInt8Storage:
    """Corpus(storage="int8", mesh=...): int8 code shards + sharded
    scales, int8c kernel mode — 4x the corpus rows per chip."""

    def _dequant(self, c):
        from polars_matmul_tpu.api.search import _quantize_rows_np

        codes, scales = _quantize_rows_np(np.asarray(c, np.float32))
        return codes.astype(np.float32) * scales[:, None]

    def test_matches_dequantized_oracle(self, mesh8):
        rng = np.random.default_rng(96)
        q = rng.standard_normal((10, 48)).astype(np.float32)
        c = rng.standard_normal((333, 48)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8", mesh=mesh8)
        cdeq = self._dequant(c)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 6, metric)
            i0, v0 = pmt.topk(q, cdeq, 6, metric)
            assert (i1 == i0).mean() > 0.97, (metric, (i1 == i0).mean())
            np.testing.assert_allclose(v1, v0, rtol=2e-4, atol=2e-4)
        # shards are genuinely int8, and so is the per-shard prep
        assert str(h._device.data.dtype) == "int8"
        assert h._device.scales is not None
        for cp, cb in h._device._prepared.values():
            assert str(cp.dtype) == "int8"
            assert cb.shape[0] == 2

    def test_ring_merge_and_mask(self, mesh8):
        rng = np.random.default_rng(97)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        mask = rng.random(200) < 0.4
        mask[:8] = True
        h = pmt.Corpus(c, storage="int8", mesh=mesh8,
                       config=pmt.SearchConfig(merge="ring"))
        i, v = h.topk(q, 5, "dot", mask=mask)
        assert mask[i.reshape(-1)].all()
        i0, _ = pmt.topk(q, self._dequant(c), 5, "dot", mask=mask)
        np.testing.assert_array_equal(i, i0)

    def test_fallback_path_dequantizes_per_shard(self, mesh8):
        """k_local > max_fused_k diverts to the non-prepared path, which
        must dequantize the int8 shards locally before the XLA fallback
        (shards must exceed 1024 rows — smaller k now stays fused)."""
        rng = np.random.default_rng(98)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((9600, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8", mesh=mesh8)
        i, v = h.topk(q, 1100, "cosine")  # k_local=1100 > 1024
        assert i.shape == (4, 1100)
        i0, v0 = pmt.topk(q, self._dequant(c), 1100, "cosine")
        assert (i == i0).mean() > 0.97

    def test_matmul_dequantizes_per_shard(self, mesh8):
        rng = np.random.default_rng(99)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((64, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8", mesh=mesh8)
        out = h.matmul(q)
        assert out.dtype == np.float32
        np.testing.assert_allclose(out, q @ self._dequant(c).T,
                                   rtol=1e-5, atol=1e-5)

    def test_chunked_prep_and_save_load(self, mesh8, tmp_path):
        rng = np.random.default_rng(100)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((900, 32)).astype(np.float32)
        h1 = pmt.Corpus(c, storage="int8", mesh=mesh8)
        h2 = pmt.Corpus(c, storage="int8", mesh=mesh8,
                        config=pmt.SearchConfig(prep_chunk_bytes=8192))
        i1, v1 = h1.topk(q, 5, "euclidean")
        i2, v2 = h2.topk(q, 5, "euclidean")
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-6, atol=1e-6)
        # mesh handles save gathered shards; reload single-device matches
        p = tmp_path / "mesh_i8.npz"
        h1.save(p)
        h3 = pmt.Corpus.load(p)
        assert h3.n == 900 and h3.storage == "int8"
        i3, v3 = h3.topk(q, 5, "euclidean")
        np.testing.assert_array_equal(i1, i3)


def test_mesh_save_load_f32(mesh8, tmp_path):
    """Regression: save() on a mesh handle must gather ShardedCorpus.data
    (it used to hand the dataclass itself to np.asarray)."""
    rng = np.random.default_rng(101)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c = rng.standard_normal((100, 16)).astype(np.float32)
    h = pmt.Corpus(c, mesh=mesh8)
    i0, v0 = h.topk(q, 3)
    p = tmp_path / "mesh_f32.npz"
    h.save(p)
    h2 = pmt.Corpus.load(p, mesh=mesh8)   # re-shard at load
    i1, v1 = h2.topk(q, 3)
    np.testing.assert_array_equal(i0, i1)
    h3 = pmt.Corpus.load(p)               # or load single-device
    i2, _ = h3.topk(q, 3)
    np.testing.assert_array_equal(i0, i2)


def test_sharded_int8_shared_storage(mesh8):
    """Mesh int8 uses the shared-storage layout: per-shard prepared forms
    alias the shard data (one code copy per shard), padding rows are
    masked via the synthesized live-row mask rather than k-widening, and
    indices/scores match the dequantized oracle exactly."""
    from polars_matmul_tpu.api.search import _quantize_rows_np

    rng = np.random.default_rng(105)
    q = rng.standard_normal((6, 48)).astype(np.float32)
    c = rng.standard_normal((333, 48)).astype(np.float32)
    h = pmt.Corpus(c, storage="int8", mesh=mesh8)
    # shards are padded to 4096-row multiples and 128-wide features
    assert h._device.data.shape[0] % (8 * 4096) == 0
    assert h._device.data.shape[1] == 128
    for metric in ("cosine", "dot", "euclidean"):
        i, v = h.topk(q, 5, metric)
        codes, sc = _quantize_rows_np(c)
        cdeq = codes.astype(np.float32) * sc[:, None]
        i0, v0 = pmt.topk(q, cdeq, 5, metric)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_allclose(v, v0, rtol=2e-4, atol=2e-4)
        assert (i < 333).all()               # no padding index leaks
    for cp, cb in h._device._prepared.values():
        assert cp is h._device.data          # aliased, zero extra HBM
    # euclidean min-orientation + all-pad shards + user mask compose
    mask = rng.random(333) < 0.3
    mask[:6] = True
    i2, _ = h.topk(q, 4, "euclidean", mask=mask)
    assert mask[i2.reshape(-1)].all()


def test_sharded_int4_storage(mesh8, tmp_path):
    """Corpus(storage="int4", mesh=...): nibble-packed shards + sharded
    scales, int4c kernel mode — 8x the corpus rows per chip."""
    from polars_matmul_tpu.api.search import (_quantize_rows_int4_np,
                                              _unpack_int4_np)
    from polars_matmul_tpu.kernels.fused_topk import feature_geometry

    rng = np.random.default_rng(107)
    q = rng.standard_normal((6, 48)).astype(np.float32)
    c = rng.standard_normal((333, 48)).astype(np.float32)
    h = pmt.Corpus(c, storage="int4", mesh=mesh8)
    assert h._device.data.shape[1] == 64           # packed width dpp/2
    ck, dpp, _ = feature_geometry(48)
    packed, sc = _quantize_rows_int4_np(c, ck, dpp)
    cdeq = _unpack_int4_np(packed, ck, 48).astype(np.float32) * sc[:, None]
    for metric in ("cosine", "dot", "euclidean"):
        i, v = h.topk(q, 5, metric)
        i0, v0 = pmt.topk(q, cdeq, 5, metric)
        np.testing.assert_array_equal(i, i0, err_msg=metric)
        assert (i < 333).all()
    for cp, cb in h._device._prepared.values():
        assert cp is h._device.data                # aliased shards
    # fallback (k > k_pad) + matmul dequantize per shard
    i2, _ = h.topk(q, 200)
    i3, _ = pmt.topk(q, cdeq, 200)
    np.testing.assert_array_equal(i2, i3)
    out = h.matmul(q[:2])
    np.testing.assert_allclose(out, q[:2] @ cdeq.T, rtol=1e-4, atol=1e-4)
    # mesh save -> single-device reload
    p = tmp_path / "mesh_i4.npz"
    h.save(p)
    h2 = pmt.Corpus.load(p)
    ia, _ = h2.topk(q, 5)
    ib, _ = h.topk(q, 5)
    np.testing.assert_array_equal(ia, ib)


class TestShardedUpdate:
    """Corpus.update on a mesh: the scatter routes rows to their owning
    shards and per-shard prepared forms are patched in place, so results
    after an update must match a freshly built corpus — including on
    already-compiled search programs (prep patched, not rebuilt)."""

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_update_matches_fresh_corpus(self, mesh8, storage):
        rng = np.random.default_rng(71)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((500, 32)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8, storage=storage)
        # compile + prep BEFORE the update: the patched prepared forms
        # must serve the already-compiled program
        h.topk(q, 5, "cosine")
        h.topk(q, 5, "euclidean")
        idx = np.array([0, 7, 63, 64, 255, 499])  # spans several shards
        new = rng.standard_normal((6, 32)).astype(np.float32) * 2.0
        h.update(idx, new)
        c2 = c.copy()
        c2[idx] = new
        fresh = pmt.Corpus(c2, mesh=mesh8, storage=storage)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 5, metric)
            i2, v2 = fresh.topk(q, 5, metric)
            np.testing.assert_array_equal(i1, i2, err_msg=metric)
            np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6,
                                       err_msg=metric)

    def test_update_matches_single_device(self, mesh8):
        rng = np.random.default_rng(72)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((200, 16)).astype(np.float32)
        hm = pmt.Corpus(c, mesh=mesh8)
        hs = pmt.Corpus(c)
        idx = np.array([3, 100, 199])
        new = rng.standard_normal((3, 16)).astype(np.float32)
        hm.update(idx, new)
        hs.update(idx, new)
        im, vm = hm.topk(q, 7)
        is_, vs = hs.topk(q, 7)
        np.testing.assert_array_equal(im, is_)
        np.testing.assert_allclose(vm, vs, rtol=1e-5, atol=1e-6)
        # matmul sees the new rows too (f32 view invalidated)
        np.testing.assert_allclose(hm.matmul(q), hs.matmul(q),
                                   rtol=1e-4, atol=1e-4)

    def test_update_revives_tombstoned_row_on_mesh(self, mesh8):
        rng = np.random.default_rng(73)
        c = rng.standard_normal((120, 16)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8)
        target = c[44] + rng.standard_normal(16).astype(np.float32) * 1e-3
        h.delete([44])
        i0, _ = h.topk(target[None], 1)
        assert i0[0, 0] != 44
        h.update([44], c[44][None])
        i1, _ = h.topk(target[None], 1)
        assert i1[0, 0] == 44

    def test_int8_shared_prep_stays_aliased_after_update(self, mesh8):
        rng = np.random.default_rng(74)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((300, 16)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8, storage="int8")
        h.topk(q, 4, "cosine")
        h.topk(q, 4, "dot")
        h.update(np.arange(10), c[:10] * 3.0)
        for cp, _cb in h._device._prepared.values():
            assert cp is h._device.data
        # and the patched cbp still scores correctly
        c2 = c.copy()
        c2[:10] = c[:10] * 3.0
        fresh = pmt.Corpus(c2, mesh=mesh8, storage="int8")
        for metric in ("cosine", "dot"):
            i1, v1 = h.topk(q, 4, metric)
            i2, v2 = fresh.topk(q, 4, metric)
            np.testing.assert_array_equal(i1, i2, err_msg=metric)
            np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)

    def test_update_validation_on_mesh(self, mesh8):
        rng = np.random.default_rng(75)
        c = rng.standard_normal((100, 16)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8)
        with pytest.raises(ValueError, match="must be unique"):
            h.update([1, 1], np.ones((2, 16), np.float32))
        with pytest.raises(ValueError, match="Dimension mismatch"):
            h.update([1], np.ones((1, 8), np.float32))
        with pytest.raises(ValueError, match="in \\[0, 100\\)"):
            h.update([100], np.ones((1, 16), np.float32))
        h.update(np.empty(0, np.int64), np.empty((0, 16), np.float32))


class TestShardedAdd:
    """Corpus.add on a mesh handle built with capacity=: growth is the
    same sharded scatter as update, the live count rides the compiled
    program as a traced operand, and in-capacity adds never recompile."""

    @pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "int4"])
    def test_add_matches_fresh_corpus(self, mesh8, storage):
        rng = np.random.default_rng(81)
        q = rng.standard_normal((5, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8, storage=storage, capacity=400)
        h.topk(q, 5, "cosine")        # compile + prep before the growth
        new = rng.standard_normal((57, 32)).astype(np.float32)
        assert h.add(new) == 257
        c2 = np.vstack([c, new])
        fresh = pmt.Corpus(c2, mesh=mesh8, storage=storage, capacity=400)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 6, metric)
            i2, v2 = fresh.topk(q, 6, metric)
            np.testing.assert_array_equal(i1, i2, err_msg=metric)
            np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6,
                                       err_msg=metric)
        # new rows are findable by id
        i3, _ = h.topk(new[30][None], 1, "cosine")
        if storage in ("f32", "bf16"):
            assert i3[0, 0] == 230

    def test_add_never_recompiles_search(self, mesh8):
        import jax._src.monitoring as mon

        rng = np.random.default_rng(82)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((100, 16)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8, capacity=300)
        h.topk(q, 4, "cosine")
        # warm the one-time mutation programs with a first add
        h.add(rng.standard_normal((10, 16)).astype(np.float32))
        h.topk(q, 4, "cosine")
        events = []
        cb = lambda e, **kw: events.append(e)
        mon.register_event_listener(cb)
        try:
            for _ in range(3):
                h.add(rng.standard_normal((10, 16)).astype(np.float32))
                h.topk(q, 4, "cosine")
            compiles = [e for e in events if "compil" in e.lower()]
            assert not compiles, compiles
        finally:
            if hasattr(mon, "_unregister_event_listener_by_callback"):
                mon._unregister_event_listener_by_callback(cb)

    def test_add_then_update_delete_and_save_load(self, mesh8, tmp_path):
        rng = np.random.default_rng(83)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((90, 16)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh8, storage="int8", capacity=200)
        new = rng.standard_normal((30, 16)).astype(np.float32)
        h.add(new)
        h.update([100], rng.standard_normal((1, 16)).astype(np.float32))
        h.delete([5, 119])
        p = tmp_path / "mesh_add.npz"
        h.save(p)
        h2 = pmt.Corpus.load(p, mesh=mesh8, capacity=200)
        i1, v1 = h.topk(q, 5)
        i2, v2 = h2.topk(q, 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-6)
        assert h2.n == 120 and h2.deleted_count == 2
        # loaded-with-capacity handle keeps growing
        h2.add(rng.standard_normal((10, 16)).astype(np.float32))
        assert h2.n == 130

    def test_add_requires_capacity_and_respects_it(self, mesh8):
        rng = np.random.default_rng(84)
        c = rng.standard_normal((50, 16)).astype(np.float32)
        h0 = pmt.Corpus(c, mesh=mesh8)
        with pytest.raises(ValueError, match="capacity="):
            h0.add(np.ones((1, 16), np.float32))
        h = pmt.Corpus(c, mesh=mesh8, capacity=60)
        with pytest.raises(ValueError, match="exceeds the mesh"):
            h.add(np.ones((100, 16), np.float32))
        assert h.add(np.empty((0, 16), np.float32)) == 50


class TestF64Mesh:
    """f64 corpora on a mesh must honor the both-f32 rule like the
    single-device handle: the exact f64 XLA path serves them.
    Regression (reviewer-caught): dense_f32 downcast f64 shards to f32,
    silently collapsing sub-f32-resolution differences while returning
    f64-typed results."""

    def test_f64_mesh_matches_single_device(self, mesh8):
        rng = np.random.default_rng(85)
        base = rng.standard_normal((60, 16))
        # pairs of rows identical at f32 resolution, distinct in f64
        c = np.repeat(base, 2, axis=0)
        c[1::2] *= 1.0 + 1e-12
        q = base[:6] + 1e-13
        hm = pmt.Corpus(c, mesh=mesh8)
        hs = pmt.Corpus(c)
        for metric in ("dot", "euclidean"):
            im, vm = hm.topk(q, 5, metric)
            is_, vs = hs.topk(q, 5, metric)
            np.testing.assert_array_equal(im, is_, err_msg=metric)
            np.testing.assert_allclose(vm, vs, rtol=1e-12, err_msg=metric)
        pm = hm.matmul(q)
        ps = hs.matmul(q)
        assert pm.dtype == np.float64
        # sharded panels may sum in a different order; f64-tight still
        # (an f32-truncated corpus would be off by ~1e-7 relative)
        np.testing.assert_allclose(pm, ps, rtol=1e-12)


def test_northstar_scale_1m_mesh(mesh8):
    """1M rows x 768d, k=100, int8 shards on the 8-device mesh — the
    north-star scaling config's virtual-mesh correctness run (VERDICT r02
    item 3; the real 10M-row single-chip numbers live in
    chip_smoke.py).  Under test is the distributed machinery at real
    scale — host quantization, int8 shard placement, the per-shard scan
    over the codes with global index offsets, and the candidate merge."""
    rng = np.random.default_rng(4242)
    n, dim, m, k = 1_000_000, 768, 8, 100
    # Blob structure: real neighbor structure,
    # non-uniform per-shard hit counts (iid noise would spread winners
    # evenly and never stress the merge with lopsided shards).  The noise
    # block is tiled 8x to keep single-core generation under a minute;
    # random center assignment keeps rows distinct in all but measure-zero
    # collisions (and exact duplicates are themselves a tie-break case
    # both paths must agree on).
    centers = rng.standard_normal((256, dim)).astype(np.float32)
    noise = rng.standard_normal((n // 8, dim), dtype=np.float32)
    c = centers[rng.integers(0, 256, size=n)]
    c += 0.6 * np.tile(noise, (8, 1))
    del noise
    q = centers[rng.integers(0, 256, size=m)]
    q = q + 0.6 * rng.standard_normal(q.shape).astype(np.float32)

    from polars_matmul_tpu.api.search import _quantize_rows_np

    codes, scales = _quantize_rows_np(c)
    cdeq = codes.astype(np.float32) * scales[:, None]

    h = pmt.Corpus(c, storage="int8", mesh=mesh8)
    del c
    i1, v1 = h.topk(q, k, "cosine")
    i0, v0 = pmt.topk(q, cdeq, k, "cosine")
    assert i1.shape == (m, k)
    # f32 accumulation-order differences across shard boundaries can swap
    # near-ties; demand near-total index agreement and tight scores.
    assert (i1 == i0).mean() > 0.97, (i1 == i0).mean()
    np.testing.assert_allclose(v1, v0, rtol=2e-4, atol=2e-4)
