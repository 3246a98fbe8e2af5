"""End-to-end API tests through the Arrow/NumPy surface.

Port of the reference's Python integration suite semantics
(tests/test_polars_matmul.py — TestTopk, TestMatmul, TestNumpyEquivalence,
TestErrorHandling, TestFloat32Support) against ``topk_arrow``/
``matmul_arrow``/``topk``/``matmul``/``Corpus``.  The polars-expression
variants live in test_polars_api.py (skipped when polars is absent).
"""

import numpy as np
import pyarrow as pa
import pytest

import polars_matmul_tpu as pmt


def fsl(data, dtype=np.float64):
    a = np.asarray(data, dtype=dtype)
    return pa.FixedSizeListArray.from_arrays(
        pa.array(a.reshape(-1)), a.shape[1]
    )


class TestTopkArrow:
    def test_basic_cosine(self):
        # reference test_basic_cosine
        q = pa.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        c = pa.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        out = pmt.topk_arrow(q, c, k=2)
        rows = out.to_pylist()
        assert len(rows) == 2
        assert rows[0][0]["index"] == 0
        assert abs(rows[0][0]["score"] - 1.0) < 1e-6
        assert rows[1][0]["index"] == 1
        assert abs(rows[1][0]["score"] - 1.0) < 1e-6
        # dtype contract: List[Struct{index: u32, score: f64}]
        assert out.type.value_type.field("index").type == pa.uint32()
        assert out.type.value_type.field("score").type == pa.float64()

    def test_dot_product(self):
        # reference test_dot_product
        q = pa.array([[2.0, 0.0]])
        c = pa.array([[1.0, 0.0], [3.0, 0.0]])
        rows = pmt.topk_arrow(q, c, k=2, metric="dot").to_pylist()
        assert rows[0][0]["index"] == 1
        assert abs(rows[0][0]["score"] - 6.0) < 1e-6

    def test_euclidean(self):
        # reference test_euclidean: lower is better
        q = pa.array([[0.0, 0.0]])
        c = pa.array([[3.0, 4.0], [1.0, 0.0]])
        rows = pmt.topk_arrow(q, c, k=2, metric="euclidean").to_pylist()
        assert rows[0][0]["index"] == 1
        assert abs(rows[0][0]["score"] - 1.0) < 1e-6
        assert abs(rows[0][1]["score"] - 5.0) < 1e-6

    def test_k_larger_than_corpus(self):
        # reference test_k_larger_than_corpus: clamp, not error
        q = pa.array([[1.0, 0.0]])
        c = pa.array([[1.0, 0.0], [0.0, 1.0]])
        rows = pmt.topk_arrow(q, c, k=10).to_pylist()
        assert len(rows[0]) == 2

    def test_readme_quickstart_values(self):
        # reference README.md:55-65 printed output
        q = pa.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        c = pa.array([[0.9, 0.1, 0.0], [0.1, 0.9, 0.0], [0.0, 0.1, 0.9]])
        rows = pmt.topk_arrow(q, c, k=2).to_pylist()
        assert [m["index"] for m in rows[0]] == [0, 1]
        assert abs(rows[0][0]["score"] - 0.994) < 1e-3
        assert abs(rows[0][1]["score"] - 0.110) < 1e-3
        assert [m["index"] for m in rows[1]] == [1, 0]
        # Row 2's runner-up is an exact tie (corpus 0 and 1 both score 0.0
        # against [0,0,1]); the reference's unstable quickselect printed
        # index 1 in the README, our pinned contract is lowest-index-wins.
        assert rows[2][0]["index"] == 2
        assert rows[2][1]["index"] == 0
        assert abs(rows[2][1]["score"]) < 1e-12

    def test_f32_scores_widened_to_f64(self):
        q = fsl([[1.0, 0.0]], np.float32)
        c = fsl([[1.0, 0.0], [0.5, 0.5]], np.float32)
        out = pmt.topk_arrow(q, c, k=2)
        assert out.type.value_type.field("score").type == pa.float64()


class TestMatmulArrow:
    def test_basic(self):
        q = pa.array([[1.0, 2.0], [3.0, 4.0]])
        c = pa.array([[1.0, 0.0], [0.0, 1.0]])
        out = pmt.matmul_arrow(q, c)
        assert pa.types.is_fixed_size_list(out.type)
        assert out.to_pylist() == [[1.0, 2.0], [3.0, 4.0]]

    def test_against_numpy(self, rng):
        ln = rng.standard_normal((10, 32))
        rn = rng.standard_normal((20, 32))
        out = pmt.matmul_arrow(pa.array(ln.tolist()), pa.array(rn.tolist()))
        got = np.array(out.to_pylist())
        np.testing.assert_allclose(got, ln @ rn.T, rtol=1e-5)

    def test_flatten_mode(self):
        # reference test_flatten_mode: row-major flat output
        q = pa.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
        c = pa.array([[1.0, 0.0], [0.0, 1.0]])
        out = pmt.matmul_arrow(q, c, flatten=True)
        assert len(out) == 6
        np.testing.assert_allclose(
            out.to_pylist(), [1.0, 0.0, 0.0, 1.0, 1.0, 1.0], rtol=1e-5
        )

    def test_f32_output(self):
        q = fsl([[1.0, 2.0]], np.float32)
        c = fsl([[1.0, 0.0], [0.0, 1.0]], np.float32)
        out = pmt.matmul_arrow(q, c)
        assert out.type.value_type == pa.float32()

    def test_mixed_f32_f64_uses_f64(self):
        # reference test_mixed_f32_f64_uses_f64
        q = fsl([[1.0, 2.0]], np.float32)
        c = pa.array([[1.0, 0.0]])
        out = pmt.matmul_arrow(q, c)
        assert out.type.value_type == pa.float64()


class TestErrorHandling:
    def test_invalid_metric(self):
        q = pa.array([[1.0, 0.0]])
        c = pa.array([[1.0, 0.0]])
        with pytest.raises(Exception, match="Unknown metric"):
            pmt.topk_arrow(q, c, k=1, metric="invalid_metric")

    def test_empty_query_returns_empty(self):
        # reference test_empty_query: typed empty result, no error
        q = pa.array([], type=pa.list_(pa.float64()))
        c = pa.array([[1.0, 0.0]])
        out = pmt.topk_arrow(q, c, k=1)
        assert len(out) == 0
        assert pa.types.is_list(out.type)

    def test_empty_corpus_raises(self):
        q = pa.array([[1.0, 0.0]])
        c = pa.array([], type=pa.list_(pa.float64()))
        with pytest.raises(Exception, match="Empty"):
            pmt.topk_arrow(q, c, k=1)

    def test_matmul_dimension_mismatch(self):
        q = pa.array([[1.0, 2.0]])
        c = pa.array([[1.0, 2.0, 3.0]])
        with pytest.raises(Exception, match="Dimension mismatch"):
            pmt.matmul_arrow(q, c)

    def test_topk_dimension_mismatch(self):
        q = pa.array([[1.0, 2.0]])
        c = pa.array([[1.0, 2.0, 3.0]])
        with pytest.raises(Exception, match="Dimension mismatch"):
            pmt.topk_arrow(q, c, k=1)

    def test_matmul_empty_left(self):
        q = pa.array([], type=pa.list_(pa.float64()))
        c = pa.array([[1.0, 0.0]])
        out = pmt.matmul_arrow(q, c)
        assert len(out) == 0


class TestNumpyEquivalence:
    def test_cosine_full_k_matches_numpy(self, rng):
        # reference TestNumpyEquivalence with k = full corpus
        q = rng.standard_normal((5, 16))
        c = rng.standard_normal((20, 16))
        idx, scores = pmt.topk(q, c, 20, "cosine")
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        cn = c / np.linalg.norm(c, axis=1, keepdims=True)
        expected = qn @ cn.T
        for i in range(5):
            np.testing.assert_allclose(
                sorted(scores[i], reverse=True),
                sorted(expected[i], reverse=True),
                rtol=1e-5,
            )


class TestNumpyApi:
    def test_topk_dtypes(self, qc_f32):
        q, c = qc_f32
        idx, scores = pmt.topk(q, c, 5)
        assert idx.dtype == np.uint32
        assert scores.dtype == np.float64
        assert idx.shape == (q.shape[0], 5)

    def test_matmul_dtype_rule(self, qc_f32):
        q, c = qc_f32
        assert pmt.matmul(q, c).dtype == np.float32
        assert pmt.matmul(q.astype(np.float64), c).dtype == np.float64

    def test_corpus_handle(self, qc_f32):
        q, c = qc_f32
        corpus = pmt.Corpus(c)
        idx, scores = corpus.topk(q, 5)
        i0, s0 = pmt.topk(q, c, 5)
        np.testing.assert_array_equal(idx, i0)
        np.testing.assert_allclose(scores, s0, rtol=1e-6)

    def test_corpus_handle_dim_mismatch(self, qc_f32):
        _, c = qc_f32
        corpus = pmt.Corpus(c)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            corpus.topk(np.zeros((2, 3), np.float32), 1)

    def test_corpus_empty_raises(self):
        with pytest.raises(ValueError, match="Empty"):
            pmt.Corpus(np.zeros((0, 4), np.float32))


class TestResultPacking:
    """The single-transfer result fetch must never move int32 indices
    through f32 space: small ints bitcast to f32 are denormals, which a
    float pipeline may flush to zero in transit (regression: indices all
    came back 0 on real hardware while CPU tests stayed green)."""

    def test_f32_pack_is_integer_space(self):
        import jax.numpy as jnp

        from polars_matmul_tpu.api.search import _pack_pair, _unpack_pair

        vals = jnp.asarray(
            np.array([[0.5, -1.25], [3.0, 1e-30]], np.float32)
        )
        idx = jnp.asarray(np.array([[1, 4999], [0, 7]], np.int32))
        packed = _pack_pair(vals, idx)
        assert packed.dtype == jnp.int32
        v, i = _unpack_pair(np.asarray(packed), 2)
        np.testing.assert_array_equal(v, np.asarray(vals))
        np.testing.assert_array_equal(i, np.asarray(idx))

    def test_f64_pack_roundtrip(self):
        import jax.numpy as jnp

        from polars_matmul_tpu.api.search import _pack_pair, _unpack_pair

        vals = jnp.asarray(np.array([[0.5, -1.25]], np.float64))
        idx = jnp.asarray(np.array([[123456789, 2]], np.int32))
        packed = _pack_pair(vals, idx)
        v, i = _unpack_pair(np.asarray(packed), 2)
        np.testing.assert_array_equal(v, np.asarray(vals))
        np.testing.assert_array_equal(i, np.asarray(idx))


class TestPreparedCorpus:
    """Corpus caches the prepared (pre-scaled/split/padded) corpus per
    metric; results must be identical to the one-shot path."""

    def test_prepared_matches_oneshot(self):
        rng = np.random.default_rng(11)
        q = rng.standard_normal((23, 48)).astype(np.float32)
        c = rng.standard_normal((900, 48)).astype(np.float32)
        h = pmt.Corpus(c)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 7, metric)
            i0, v0 = pmt.topk(q, c, 7, metric)
            np.testing.assert_array_equal(i1, i0)
            np.testing.assert_allclose(v1, v0, rtol=1e-6, atol=1e-7)
        # the cache holds one entry per metric now
        assert len(h._prepared) == 3

    def test_prepared_k_clamp_and_reuse(self):
        rng = np.random.default_rng(12)
        q = rng.standard_normal((5, 16)).astype(np.float32)
        c = rng.standard_normal((9, 16)).astype(np.float32)
        h = pmt.Corpus(c)
        i1, v1 = h.topk(q, 99, "cosine")   # clamps to 9
        assert i1.shape == (5, 9)
        i2, v2 = h.topk(q, 3, "cosine")    # reuses the cached prep
        np.testing.assert_array_equal(i2, i1[:, :3])


def test_corpus_topk_k_nonpositive():
    """Corpus.topk must mirror module-level topk for k <= 0."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    c = rng.standard_normal((5, 8)).astype(np.float32)
    h = pmt.Corpus(c)
    for k in (0, -2):
        i, v = h.topk(q, k)
        assert i.shape == (3, 0) and v.shape == (3, 0)


def test_prepared_corpus_chunked_prep_matches_oneshot():
    """Chunked preparation (big-corpus path) must produce identical
    prepared buffers and results to the one-shot path."""
    rng = np.random.default_rng(17)
    q = rng.standard_normal((9, 40)).astype(np.float32)
    c = rng.standard_normal((777, 40)).astype(np.float32)
    for metric in ("cosine", "euclidean"):
        big = pmt.Corpus(c)
        # force chunking: a few KB per chunk
        small = pmt.Corpus(c, config=pmt.SearchConfig(prep_chunk_bytes=1 << 16))
        i1, v1 = big.topk(q, 11, metric)
        i2, v2 = small.topk(q, 11, metric)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)


class TestFilteredSearch:
    """mask= excludes corpus rows from selection (new capability; folded
    into the kernel's epilogue bias so it costs one vector op)."""

    def _oracle(self, q, c, k, mask, metric="cosine"):
        qq = q.astype(np.float64)
        cc = c.astype(np.float64)
        if metric == "cosine":
            s = (qq / np.linalg.norm(qq, axis=1, keepdims=True)) @ (
                cc / np.linalg.norm(cc, axis=1, keepdims=True)).T
            s[:, ~mask] = -np.inf
            idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
        else:
            s = np.sqrt(np.maximum(
                (qq*qq).sum(1)[:, None] + (cc*cc).sum(1)[None, :]
                - 2 * qq @ cc.T, 0))
            s[:, ~mask] = np.inf
            idx = np.argsort(s, axis=1, kind="stable")[:, :k]
        return idx

    @pytest.mark.parametrize("metric", ["cosine", "euclidean"])
    def test_masked_matches_oracle(self, metric):
        rng = np.random.default_rng(41)
        q = rng.standard_normal((9, 32)).astype(np.float32)
        c = rng.standard_normal((500, 32)).astype(np.float32)
        mask = rng.random(500) < 0.3
        i, v = pmt.topk(q, c, 7, metric, mask=mask)
        oidx = self._oracle(q, c, 7, mask, metric)
        np.testing.assert_array_equal(i.astype(np.int64), oidx)
        assert mask[i.reshape(-1)].all()  # every hit satisfies the filter

    def test_masked_corpus_handle_and_f64(self):
        rng = np.random.default_rng(42)
        q = rng.standard_normal((5, 16)).astype(np.float32)
        c = rng.standard_normal((200, 16)).astype(np.float32)
        mask = np.zeros(200, bool)
        mask[[3, 77, 150]] = True
        h = pmt.Corpus(c)
        i1, v1 = h.topk(q, 3, "cosine", mask=mask)
        i0, v0 = pmt.topk(q, c, 3, "cosine", mask=mask)
        np.testing.assert_array_equal(i1, i0)
        assert set(np.unique(i1)) <= {3, 77, 150}
        # f64 path (XLA fallback) honors the mask too
        i2, _ = pmt.topk(q.astype(np.float64), c.astype(np.float64), 3,
                         "cosine", mask=mask)
        np.testing.assert_array_equal(i2, i0)

    def test_mask_k_exceeds_matches_sentinels(self):
        rng = np.random.default_rng(43)
        q = rng.standard_normal((2, 8)).astype(np.float32)
        c = rng.standard_normal((50, 8)).astype(np.float32)
        mask = np.zeros(50, bool)
        mask[7] = True
        i, v = pmt.topk(q, c, 4, "cosine", mask=mask)
        assert (i[:, 0] == 7).all()
        assert np.isneginf(v[:, 1:]).all()  # sentinel beyond matches
        i2, v2 = pmt.topk(q, c, 4, "euclidean", mask=mask)
        assert (i2[:, 0] == 7).all()
        assert np.isposinf(v2[:, 1:]).all()

    def test_mask_shape_validated(self):
        rng = np.random.default_rng(44)
        q = rng.standard_normal((2, 8)).astype(np.float32)
        c = rng.standard_normal((50, 8)).astype(np.float32)
        with pytest.raises(ValueError, match="mask"):
            pmt.topk(q, c, 3, mask=np.ones(49, bool))


def test_masked_nan_rows_are_excluded():
    """Masked-out corpus rows containing NaN/inf must not poison results:
    the kernel filters by select, not arithmetic (regression: s = d + -inf
    gave NaN when d was NaN and every query returned all-NaN)."""
    rng = np.random.default_rng(61)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    c = rng.standard_normal((40, 8)).astype(np.float32)
    c[5] = np.nan
    c[11] = np.inf
    mask = np.ones(40, bool)
    mask[[5, 11]] = False
    for metric in ("dot", "cosine", "euclidean"):
        i, v = pmt.topk(q, c, 3, metric, mask=mask)
        assert np.isfinite(v).all(), metric
        assert not np.isin(i, [5, 11]).any(), metric


def test_prepared_reuse_for_large_corpus_k_regimes():
    """A big corpus queried at small and large k must not build two full
    preps (reuses the existing geometry instead)."""
    rng = np.random.default_rng(62)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    c = rng.standard_normal((600, 32)).astype(np.float32)
    # tiny threshold -> everything counts as "large"
    h = pmt.Corpus(c, config=pmt.SearchConfig(prep_chunk_bytes=1 << 14))
    i1, v1 = h.topk(q, 5, "cosine")
    i2, v2 = h.topk(q, 40, "cosine")   # large-k regime
    assert len(h._prepared) == 1       # reused, not duplicated
    i0, v0 = pmt.topk(q, c, 40, "cosine")
    np.testing.assert_array_equal(i2, i0)


class TestBf16Storage:
    """Corpus(storage="bf16") halves device HBM; scores carry the ~2^-9
    corpus quantization (opt-in approximate storage)."""

    def test_matches_quantized_oracle(self):
        import ml_dtypes

        rng = np.random.default_rng(81)
        q = rng.standard_normal((12, 48)).astype(np.float32)
        c = rng.standard_normal((400, 48)).astype(np.float32)
        h = pmt.Corpus(c, storage="bf16")
        i1, v1 = h.topk(q, 6, "cosine")
        # oracle on the storage-quantized corpus
        cq = c.astype(ml_dtypes.bfloat16).astype(np.float32)
        i0, v0 = pmt.topk(q, cq, 6, "cosine")
        # selection agrees with the quantized-corpus reference up to the
        # second (hi-split of the scaled rows) quantization
        agree = (i1 == i0).mean()
        assert agree > 0.9, agree
        np.testing.assert_allclose(v1, v0, rtol=5e-2, atol=1e-2)
        # prepared corpus is genuinely bf16 (half the bytes)
        (cp, cb), = [v for v in h._prepared.values()]
        assert str(cp.dtype) == "bfloat16"
        assert cp.shape[1] < 2 * 128  # hi half only, not hi|lo

    def test_masked_and_k_regimes(self):
        rng = np.random.default_rng(82)
        q = rng.standard_normal((5, 32)).astype(np.float32)
        c = rng.standard_normal((300, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="bf16")
        mask = rng.random(300) < 0.4
        mask[:8] = True
        i, v = h.topk(q, 4, "dot", mask=mask)
        assert mask[i.reshape(-1)].all()
        i2, v2 = h.topk(q, 40, "cosine")  # large-k regime works too
        assert i2.shape == (5, 40)

    # (mesh + bf16 storage is covered in test_parallel.py: shards are
    # stored bfloat16 and searched with the same bf16c kernel mode)


def test_bf16_storage_dtype_contracts():
    """bf16 storage presents f32 semantics: f64 input is quantized and
    served on the f32 path; matmul returns f32 (regression: bfloat16
    device dtype promoted everything to f64)."""
    rng = np.random.default_rng(91)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c64 = rng.standard_normal((60, 16))          # f64 input
    h = pmt.Corpus(c64, storage="bf16")
    assert h.dtype == np.float32
    out = h.matmul(q)
    assert out.dtype == np.float32
    i, v = h.topk(q, 3)
    assert len(h._prepared) == 1                 # bf16c scan
    # any k serves from the same prep; matmul cached one dense f32 view
    i2, _ = h.topk(q, 200)
    assert i2.shape == (4, 60)
    assert len(h._prepared) == 1
    assert h._f32_view is not None


def test_bf16_storage_respects_precision_override():
    """Any precision setting on a bf16 handle runs the bf16c tier (the
    values are quantized at rest; 'highest' could only waste memory)."""
    rng = np.random.default_rng(92)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c = rng.standard_normal((60, 16)).astype(np.float32)
    h = pmt.Corpus(c, storage="bf16",
                   config=pmt.SearchConfig(precision="highest"))
    i, v = h.topk(q, 3)
    (cp, _), = [val for val in h._prepared.values()]
    assert str(cp.dtype) == "bfloat16"           # not a full f32 prep


class TestCorpusDelete:
    """Tombstone deletion rides the mask path: O(1) corpus work."""

    def test_deleted_rows_never_match(self):
        rng = np.random.default_rng(95)
        q = rng.standard_normal((6, 16)).astype(np.float32)
        c = rng.standard_normal((80, 16)).astype(np.float32)
        h = pmt.Corpus(c)
        i0, _ = h.topk(q, 3)
        top_hits = set(np.unique(i0[:, 0]).tolist())
        assert h.delete(list(top_hits)) == len(top_hits)
        assert h.deleted_count == len(top_hits)
        i1, _ = h.topk(q, 3)
        assert not (np.isin(i1, list(top_hits))).any()
        # combines with a user mask
        user = np.ones(80, bool)
        user[: 40] = False
        i2, _ = h.topk(q, 3, mask=user)
        assert (i2 >= 40).all()
        assert not (np.isin(i2, list(top_hits))).any()

    def test_delete_bounds_checked(self):
        c = np.eye(4, dtype=np.float32)
        h = pmt.Corpus(c)
        with pytest.raises(ValueError, match="delete indices"):
            h.delete([4])

    def test_mesh_distributed_delete(self):
        # tombstones work on the sharded path too (mask shards with data)
        import jax

        devs = jax.devices()[:4]
        mesh = pmt.make_mesh(1, 4, devices=devs)
        rng = np.random.default_rng(96)
        q = rng.standard_normal((3, 8)).astype(np.float32)
        c = rng.standard_normal((40, 8)).astype(np.float32)
        h = pmt.Corpus(c, mesh=mesh)
        i0, _ = h.topk(q, 2)
        kill = int(i0[0, 0])
        h.delete([kill])
        i1, _ = h.topk(q, 2)
        assert not (i1 == kill).any()


class TestHalfPrecisionQueries:
    """Corpus.topk accepts f16 / bf16 queries: served on the f32 path,
    uploaded at half the bytes, upcast on device (new-API policy, like
    bf16 storage; module-level topk keeps reference cast-up semantics)."""

    def test_f16_queries_match_f32(self):
        rng = np.random.default_rng(101)
        q = rng.standard_normal((8, 64)).astype(np.float32)
        c = rng.standard_normal((500, 64)).astype(np.float32)
        h = pmt.Corpus(c)
        i32, v32 = h.topk(q, 10, "cosine")
        i16, v16 = h.topk(q.astype(np.float16), 10, "cosine")
        # query quantization is ~1e-3 relative: rankings nearly identical
        agree = (i16 == i32).mean()
        assert agree > 0.9, agree
        np.testing.assert_allclose(v16, v32, rtol=5e-3, atol=5e-3)
        assert v16.dtype == np.float64  # output contract unchanged

    def test_bf16_queries_accepted(self):
        import ml_dtypes

        rng = np.random.default_rng(102)
        q = rng.standard_normal((4, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        h = pmt.Corpus(c)
        i32, _ = h.topk(q, 5, "dot")
        ib, _ = h.topk(q.astype(ml_dtypes.bfloat16), 5, "dot")
        assert (ib == i32).mean() > 0.85

    def test_f16_queries_euclidean_and_fallback(self):
        rng = np.random.default_rng(103)
        q16 = rng.standard_normal((4, 16)).astype(np.float16)
        c = rng.standard_normal((300, 16)).astype(np.float32)
        h = pmt.Corpus(c)
        i, v = h.topk(q16, 3, "euclidean")
        assert (v >= 0).all()          # finalize ran in f32
        # 128 < k <= 1024 now stays fused (auto-raised carry width)
        i2, v2 = h.topk(q16, 200, "cosine")
        assert i2.shape == (4, 200)


class TestCorpusAdd:
    """Dynamic corpus growth: in-place row writes into capacity-padded
    prepared buffers; compiled programs reused (static shapes + masking)."""

    def _oracle(self, q, c, k):
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        cn = c / np.linalg.norm(c, axis=1, keepdims=True)
        s = qn @ cn.T
        return np.argsort(-s, axis=1)[:, :k]

    def test_add_within_capacity_zero_reprep(self):
        rng = np.random.default_rng(111)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c0 = rng.standard_normal((200, 32)).astype(np.float32)
        extra = rng.standard_normal((50, 32)).astype(np.float32)
        h = pmt.Corpus(c0, capacity=400)
        i_before, _ = h.topk(q, 5)           # builds the prepared form
        cp_before, _ = next(iter(h._prepared.values()))
        assert h.add(extra) == 250
        cp_after, _ = next(iter(h._prepared.values()))
        assert cp_after.shape == cp_before.shape      # spliced, not rebuilt
        i, v = h.topk(q, 5)
        oracle = self._oracle(q, np.vstack([c0, extra]), 5)
        assert (i == oracle).mean() > 0.99
        # a genuinely new row is reachable by its new index (cosine would
        # tie a scaled copy back to the original, lowest-index-wins)
        probe = rng.standard_normal((1, 32)).astype(np.float32)
        h.add(probe)
        ip, vp = h.topk(probe, 1)
        assert ip[0, 0] == 250                        # the row just added
        np.testing.assert_allclose(vp[0, 0], 1.0, atol=1e-4)

    def test_add_beyond_capacity_grows(self):
        rng = np.random.default_rng(112)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c0 = rng.standard_normal((100, 16)).astype(np.float32)
        h = pmt.Corpus(c0)                   # capacity == n
        h.topk(q, 3)
        extra = rng.standard_normal((30, 16)).astype(np.float32)
        assert h.add(extra) == 130
        assert h._cap >= 130
        i, _ = h.topk(q, 3)
        oracle = self._oracle(q, np.vstack([c0, extra]), 3)
        assert (i == oracle).mean() > 0.99

    def test_add_euclidean_bias_spliced(self):
        rng = np.random.default_rng(113)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c0 = rng.standard_normal((80, 16)).astype(np.float32)
        h = pmt.Corpus(c0, capacity=200)
        h.topk(q, 3, "euclidean")            # cache the euclid prep
        h.add(q)                             # queries themselves: distance 0
        i, v = h.topk(q, 1, "euclidean")
        np.testing.assert_array_equal(i[:, 0], np.arange(80, 84))
        # self-distance ~ sqrt(eps_bf16x3 * |q|^2) under the default
        # precision: ~1e-2 noise through the sqrt's cancellation
        np.testing.assert_allclose(v[:, 0], 0.0, atol=5e-2)

    def test_add_then_delete_then_mask(self):
        rng = np.random.default_rng(114)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c0 = rng.standard_normal((50, 16)).astype(np.float32)
        h = pmt.Corpus(c0, capacity=100)
        h.delete([0, 1])
        h.add(q * 5.0)                       # rows 50..52, exact matches
        i, _ = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [50, 51, 52])
        h.delete([50])
        i2, _ = h.topk(q[:1], 1)
        assert i2[0, 0] != 50                # tombstone covers added rows

    def test_add_updates_matmul_and_fallback(self):
        rng = np.random.default_rng(115)
        q = rng.standard_normal((3, 8)).astype(np.float32)
        c0 = rng.standard_normal((40, 8)).astype(np.float32)
        extra = rng.standard_normal((10, 8)).astype(np.float32)
        h = pmt.Corpus(c0, capacity=64)
        h.add(extra)
        out = h.matmul(q)
        assert out.shape == (3, 50)
        np.testing.assert_allclose(out, q @ np.vstack([c0, extra]).T,
                                   rtol=1e-5, atol=1e-5)
        i, _ = h.topk(q, 200)                # k clamps to the live rows
        assert i.shape == (3, 50)

    def test_add_bf16_storage(self):
        rng = np.random.default_rng(116)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c0 = rng.standard_normal((60, 16)).astype(np.float32)
        h = pmt.Corpus(c0, storage="bf16", capacity=100)
        h.topk(q, 3)
        h.add(q * 4.0)
        i, _ = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [60, 61, 62])

    def test_add_f64_handle(self):
        rng = np.random.default_rng(117)
        q = rng.standard_normal((3, 8))
        c0 = rng.standard_normal((30, 8))
        h = pmt.Corpus(c0, capacity=50)
        h.add(q * 3.0)
        i, _ = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [30, 31, 32])

    def test_add_errors(self):
        rng = np.random.default_rng(118)
        c0 = rng.standard_normal((20, 8)).astype(np.float32)
        h = pmt.Corpus(c0)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            h.add(rng.standard_normal((2, 9)).astype(np.float32))
        assert h.add(np.empty((0, 8), np.float32)) == 20
        # mesh handles support add only when built with capacity= (the
        # reserved rows are what make growth recompile-free)
        import jax

        if len(jax.devices()) >= 8:
            hm = pmt.Corpus(c0, mesh=pmt.make_mesh(1, 8))
            with pytest.raises(ValueError, match="capacity"):
                hm.add(c0[:2])


class TestInt8Storage:
    """Corpus(storage="int8"): per-row symmetric int8 codes + f32 scales —
    a quarter of the f32 HBM and upload bytes.  The scan converts each
    step's codes to bf16 (int8 values are bf16-exact) and folds the
    dequant scale into the epilogue, so results match the DEQUANTIZED
    corpus almost exactly; recall vs exact f32 carries the quantization."""

    def _dequant(self, c):
        from polars_matmul_tpu.api.search import _quantize_rows_np

        codes, scales = _quantize_rows_np(np.asarray(c, np.float32))
        return codes.astype(np.float32) * scales[:, None]

    def test_matches_dequantized_oracle_all_metrics(self):
        rng = np.random.default_rng(121)
        q = rng.standard_normal((12, 48)).astype(np.float32)
        c = rng.standard_normal((400, 48)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        cdeq = self._dequant(c)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 6, metric)
            i0, v0 = pmt.topk(q, cdeq, 6, metric)
            assert (i1 == i0).mean() > 0.97, (metric, (i1 == i0).mean())
            np.testing.assert_allclose(v1, v0, rtol=2e-4, atol=2e-4)
        # prepared corpus is genuinely int8 codes (quarter of the bytes),
        # shared across metrics after the first call built each form
        for cp, cb in h._prepared.values():
            assert str(cp.dtype) == "int8"
            assert cb.shape[0] == 2           # scale row | bias row

    def test_recall_vs_exact_f32(self):
        rng = np.random.default_rng(122)
        q = rng.standard_normal((40, 128)).astype(np.float32)
        c = rng.standard_normal((2000, 128)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        i1, _ = h.topk(q, 10)
        i0, _ = pmt.topk(q, c, 10)
        recall = np.mean([
            len(set(i1[r]) & set(i0[r])) / 10 for r in range(len(q))
        ])
        assert recall > 0.95, recall

    def test_bigk_stays_on_codes(self):
        """128 < k <= 1024 on int8 storage runs the fused big-k path
        (int8c gstack) straight from the codes — never a dense f32 view —
        and matches the dequantized oracle."""
        rng = np.random.default_rng(124)
        q = rng.standard_normal((4, 32)).astype(np.float32)
        c = rng.standard_normal((900, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        i1, v1 = h.topk(q, 200, "cosine")
        assert i1.shape == (4, 200)
        i0, v0 = pmt.topk(q, self._dequant(c), 200, "cosine")
        assert (i1 == i0).mean() > 0.97
        np.testing.assert_allclose(v1, v0, rtol=2e-4, atol=2e-4)
        assert h._f32_view is None  # the dense fallback view never built

    def test_dtype_contracts_and_fallbacks(self):
        rng = np.random.default_rng(123)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c64 = rng.standard_normal((60, 16))          # f64 input
        h = pmt.Corpus(c64, storage="int8")
        assert h.dtype == np.float32
        out = h.matmul(q)                            # dequantized panel
        assert out.dtype == np.float32
        np.testing.assert_allclose(
            out, q @ self._dequant(c64).T, rtol=1e-5, atol=1e-5)
        i, v = h.topk(q, 3)
        assert len(h._prepared) == 1                 # int8c scan
        i2, v2 = h.topk(q, 200)                      # k clamps to 60
        assert i2.shape == (4, 60)
        assert len(h._prepared) == 1
        assert h._f32_view is not None               # built by matmul
        # the scan ranks the same dequantized values; its hi|lo query
        # split differs from the exact product in the last bits, so
        # quantized near-ties may swap — pair-consistency, not exact
        # index equality.
        i3, v3 = pmt.topk(q, self._dequant(c64), 60)
        mism = np.asarray(i2) != np.asarray(i3)
        v2, v3 = np.asarray(v2), np.asarray(v3)
        assert np.all(np.abs(v2[mism] - v3[mism])
                      <= 1e-5 + 1e-5 * np.abs(v2[mism])), (
            "index mismatch without score tie")

    def test_precision_override_ignored(self):
        rng = np.random.default_rng(124)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((60, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8",
                       config=pmt.SearchConfig(precision="highest"))
        h.topk(q, 3)
        (cp, _), = [val for val in h._prepared.values()]
        assert str(cp.dtype) == "int8"               # not a full f32 prep

    def test_masked_delete_and_half_queries(self):
        rng = np.random.default_rng(125)
        q = rng.standard_normal((5, 32)).astype(np.float32)
        c = rng.standard_normal((300, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        mask = rng.random(300) < 0.4
        mask[:8] = True
        i, v = h.topk(q, 4, "dot", mask=mask)
        assert mask[i.reshape(-1)].all()
        h.delete([int(i[0, 0])])
        i2, _ = h.topk(q, 4, "dot", mask=mask)
        assert int(i[0, 0]) not in set(i2[0].tolist())
        i3, _ = h.topk(q.astype(np.float16), 4)      # half-precision queries
        assert i3.shape == (5, 4)

    def test_capacity_add(self):
        rng = np.random.default_rng(126)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c0 = rng.standard_normal((100, 16)).astype(np.float32)
        h = pmt.Corpus(c0, storage="int8", capacity=200)
        h.topk(q, 3)                                 # build prepared form
        cp_before, _ = next(iter(h._prepared.values()))
        h.add(q * 4.0)                               # exact matches appended
        cp_after, _ = next(iter(h._prepared.values()))
        assert cp_after.shape == cp_before.shape     # spliced, not rebuilt
        i, v = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [100, 101, 102, 103])
        np.testing.assert_allclose(v[:, 0], 1.0, atol=1e-2)
        # grow beyond capacity too
        extra = rng.standard_normal((150, 16)).astype(np.float32)
        assert h.add(extra) == 254
        i2, _ = h.topk(q, 1)
        np.testing.assert_array_equal(i2[:, 0], [100, 101, 102, 103])

    def test_chunked_prep_matches_oneshot(self):
        rng = np.random.default_rng(127)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c = rng.standard_normal((900, 32)).astype(np.float32)
        h1 = pmt.Corpus(c, storage="int8")
        # force the chunked path: raw int8 bytes (900*32) > 8192
        h2 = pmt.Corpus(c, storage="int8",
                        config=pmt.SearchConfig(prep_chunk_bytes=8192))
        i1, v1 = h1.topk(q, 5, "euclidean")
        i2, v2 = h2.topk(q, 5, "euclidean")
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-6, atol=1e-6)

    # (mesh + int8 storage is covered in test_parallel.py: int8 code
    # shards + sharded scales, searched with the same int8c kernel mode)


class TestSaveLoad:
    """Corpus.save/load: storage-native persistence (int8 corpora
    round-trip their codes bit-exactly, never requantized)."""

    def test_f32_roundtrip_with_tombstones(self, tmp_path):
        rng = np.random.default_rng(131)
        q = rng.standard_normal((5, 16)).astype(np.float32)
        c = rng.standard_normal((80, 16)).astype(np.float32)
        h = pmt.Corpus(c)
        h.delete([0, 7])
        i0, v0 = h.topk(q, 4)
        p = tmp_path / "corpus.npz"
        h.save(p)
        h2 = pmt.Corpus.load(p)
        assert (h2.n, h2.dim, h2.storage) == (80, 16, "f32")
        assert h2.deleted_count == 2
        i1, v1 = h2.topk(q, 4)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(v0, v1, rtol=1e-6)

    def test_int8_roundtrip_bit_exact(self, tmp_path):
        rng = np.random.default_rng(132)
        q = rng.standard_normal((5, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        i0, v0 = h.topk(q, 5, "euclidean")
        p = tmp_path / "corpus_i8.npz"
        h.save(p)
        # the file stores int8 codes, not f32
        with np.load(p) as z:
            assert z["data"].dtype == np.int8
            assert z["scales"].dtype == np.float32
        h2 = pmt.Corpus.load(p)
        np.testing.assert_array_equal(
            np.asarray(h._device), np.asarray(h2._device))  # codes bit-exact
        i1, v1 = h2.topk(q, 5, "euclidean")
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(v0, v1, rtol=1e-6, atol=1e-6)

    def test_bf16_roundtrip(self, tmp_path):
        rng = np.random.default_rng(133)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((60, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="bf16")
        i0, v0 = h.topk(q, 3)
        p = tmp_path / "corpus_bf16.npz"
        h.save(p)
        h2 = pmt.Corpus.load(p)
        assert h2.storage == "bf16"
        i1, v1 = h2.topk(q, 3)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(v0, v1, rtol=1e-6)

    def test_load_with_capacity_then_add(self, tmp_path):
        rng = np.random.default_rng(134)
        q = rng.standard_normal((3, 8)).astype(np.float32)
        c = rng.standard_normal((40, 8)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        p = tmp_path / "c.npz"
        h.save(p)
        h2 = pmt.Corpus.load(p, capacity=100)
        h2.add(q * 2.0)
        i, _ = h2.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [40, 41, 42])

    def test_prequantized_constructor_contracts(self):
        rng = np.random.default_rng(135)
        c = rng.standard_normal((30, 8)).astype(np.float32)
        from polars_matmul_tpu.api.search import _quantize_rows_np

        codes, scales = _quantize_rows_np(c)
        h = pmt.Corpus(codes, storage="int8", scales=scales)
        q = rng.standard_normal((3, 8)).astype(np.float32)
        i0, v0 = pmt.Corpus(c, storage="int8").topk(q, 3)
        i1, v1 = h.topk(q, 3)
        np.testing.assert_array_equal(i0, i1)
        with pytest.raises(ValueError, match="require scales"):
            pmt.Corpus(codes, storage="int8")
        with pytest.raises(ValueError, match="storage='int8'"):
            pmt.Corpus(codes)
        with pytest.raises(ValueError, match="scales must have shape"):
            pmt.Corpus(codes, storage="int8", scales=scales[:5])
        with pytest.raises(ValueError, match="only meaningful"):
            pmt.Corpus(c, scales=np.ones(30, np.float32))


class TestInt8SharedStorage:
    """int8 single-device corpora keep ONE code buffer: the prepared cp
    aliases the storage buffer (codes never change under prep), so int8
    residency is codes + tiny scale/bias rows — not two copies."""

    def test_prepared_aliases_storage(self):
        rng = np.random.default_rng(141)
        q = rng.standard_normal((5, 48)).astype(np.float32)
        c = rng.standard_normal((300, 48)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        for metric in ("cosine", "dot", "euclidean"):
            h.topk(q, 4, metric)
        assert len(h._prepared) == 3
        for cp, cb in h._prepared.values():
            assert cp is h._device            # aliased, zero extra HBM
            assert cb.shape == (2, h._device.shape[0])

    def test_k_regimes_share_bias_rows(self):
        rng = np.random.default_rng(142)
        q = rng.standard_normal((4, 32)).astype(np.float32)
        c = rng.standard_normal((200, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        h.topk(q, 5)
        (cp, cb), = h._prepared.values()
        h.topk(q, 40)                # any k serves from the same prep
        (cp2, cb2), = h._prepared.values()
        assert cp2 is h._device and cb2 is cb

    def test_add_splices_alias_and_bias(self):
        rng = np.random.default_rng(143)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((100, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8", capacity=300)
        h.topk(q, 3)
        h.add(q * 5.0)
        (cp, cb), = [v for v in h._prepared.values()]
        assert cp is h._device                # still aliased after add
        i, v = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [100, 101, 102])
        np.testing.assert_allclose(v[:, 0], 1.0, atol=1e-2)

    def test_chunked_bias_matches_oneshot(self):
        rng = np.random.default_rng(144)
        q = rng.standard_normal((5, 32)).astype(np.float32)
        c = rng.standard_normal((600, 32)).astype(np.float32)
        h1 = pmt.Corpus(c, storage="int8")
        # tiny chunk budget forces the chunked bias loop
        h2 = pmt.Corpus(c, storage="int8",
                        config=pmt.SearchConfig(prep_chunk_bytes=1))
        for metric in ("cosine", "euclidean"):
            i1, v1 = h1.topk(q, 5, metric)
            i2, v2 = h2.topk(q, 5, metric)
            np.testing.assert_array_equal(i1, i2)
            np.testing.assert_allclose(v1, v2, rtol=1e-6, atol=1e-6)


class TestReviewRegressions:
    """Pinned regressions from the sixth review pass."""

    def test_int8_copy_path_never_leaks_pad_indices(self):
        # block_n=1536 (legal: multiple of 128) doesn't divide the 4096-
        # padded int8 buffer -> copy-path prep; its zero pad rows must be
        # bias-masked even without capacity= (they used to surface as
        # index >= n with score 0.0 when all true scores are negative).
        rng = np.random.default_rng(151)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = -np.abs(rng.standard_normal((100, 16))).astype(np.float32)
        qpos = np.abs(q)  # all dots with -|c| rows are negative
        h = pmt.Corpus(c, storage="int8",
                       config=pmt.SearchConfig(block_n=1536))
        i, v = h.topk(qpos, 5, "dot")
        assert (i < 100).all(), i
        assert (np.asarray(v) < 0).all()

    def test_prune_config_validated(self):
        # the old kernel's knobs are gone, and so are the precisions that
        # would leave an f32 product to the backend default (TF32)
        for gone in ("prune", "selection", "k_pad", "use_pallas"):
            with pytest.raises(TypeError):
                pmt.SearchConfig(**{gone: "auto"})
        for p in ("default", "high"):
            with pytest.raises(ValueError, match="Unknown precision"):
                pmt.SearchConfig(precision=p)
        with pytest.raises(ValueError, match="Unknown merge"):
            pmt.SearchConfig(merge="tree")
        with pytest.raises(ValueError, match="Unknown precision"):
            pmt.SearchConfig(precision="fp8")

    def test_bf16_add_splice_matches_rebuild(self):
        # the spliced prepared rows must derive from the STORED bf16
        # values: after add, a fresh handle built from the same logical
        # corpus must score identically
        rng = np.random.default_rng(152)
        q = rng.standard_normal((6, 32)).astype(np.float32)
        c0 = rng.standard_normal((120, 32)).astype(np.float32)
        extra = rng.standard_normal((40, 32)).astype(np.float32)
        h = pmt.Corpus(c0, storage="bf16", capacity=200)
        h.topk(q, 5)                          # build prep, then splice
        h.add(extra)
        i1, v1 = h.topk(q, 5)
        h2 = pmt.Corpus(np.vstack([c0, extra]), storage="bf16",
                        capacity=200)
        i2, v2 = h2.topk(q, 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=0, atol=0)  # bit-equal

    def test_highdim_quantized_never_builds_f32_view(self):
        # high-dim quantized storage must serve from the codes, never
        # from a cached 4x dense f32 copy
        rng = np.random.default_rng(153)
        dim = 8600
        q = (rng.standard_normal((3, dim)) / 90).astype(np.float32)
        c = (rng.standard_normal((50, dim)) / 90).astype(np.float32)
        h = pmt.Corpus(c, storage="int8")
        i, v = h.topk(q, 4)
        assert h._f32_view is None
        assert len(h._prepared) == 1          # int8c scan taken
        i2, _ = h.topk(q, 4, "euclidean")
        assert h._f32_view is None

    def test_sharded_int8_big_k_stays_on_codes(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh")
        mesh = pmt.make_mesh(n_data=1, n_corpus=8)
        rng = np.random.default_rng(154)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((9600, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8", mesh=mesh)
        h1 = pmt.Corpus(c, storage="int8")
        i, v = h.topk(q, 1100)     # k_local > 1024: still the codes' scan
        i1, v1 = h1.topk(q, 1100)
        assert h._device._f32_view is None
        np.testing.assert_allclose(v, v1, rtol=1e-5, atol=1e-6)
        assert (i == i1).mean() > 0.99


class TestCorpusUpdate:
    """In-place row replacement (upsert): same donated-scatter machinery
    as add(); updated rows keep their indices, tombstones are revived."""

    def test_update_all_storages_all_metrics(self):
        rng = np.random.default_rng(161)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        for storage in ("f32", "bf16", "int8"):
            c = rng.standard_normal((120, 16)).astype(np.float32)
            h = pmt.Corpus(c, storage=storage)
            for metric in ("cosine", "euclidean"):
                h.topk(q, 3, metric)          # build prepared forms
            # overwrite scattered rows with exact query matches
            tgt = np.array([7, 64, 3, 99])
            h.update(tgt, q * 3.0)
            i, v = h.topk(q, 1)
            np.testing.assert_array_equal(i[:, 0], tgt, err_msg=storage)
            # the scattered splice matches a rebuilt handle exactly, for
            # both metrics (euclidean can't assert tgt wins: |3q - q| is
            # FARTHER than typical random rows in 16d)
            c2 = c.copy()
            c2[tgt] = q * 3.0
            h2 = pmt.Corpus(c2, storage=storage)
            for metric in ("cosine", "euclidean"):
                ia, va = h.topk(q, 5, metric)
                ib, vb = h2.topk(q, 5, metric)
                np.testing.assert_array_equal(ia, ib, err_msg=storage)
                np.testing.assert_allclose(va, vb, rtol=0, atol=0)

    def test_update_revives_tombstone(self):
        rng = np.random.default_rng(162)
        q = rng.standard_normal((2, 8)).astype(np.float32)
        c = rng.standard_normal((40, 8)).astype(np.float32)
        h = pmt.Corpus(c)
        h.delete([5])
        h.update([5], q[:1] * 2.0)
        i, _ = h.topk(q[:1], 1)
        assert i[0, 0] == 5
        assert h.deleted_count == 0

    def test_update_f64(self):
        rng = np.random.default_rng(163)
        q = rng.standard_normal((2, 8))
        c = rng.standard_normal((30, 8))
        h = pmt.Corpus(c)
        h.update([11, 22], q * 4.0)
        i, _ = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [11, 22])

    def test_update_errors(self):
        c = np.eye(8, dtype=np.float32)
        h = pmt.Corpus(c)
        with pytest.raises(ValueError, match="Dimension mismatch"):
            h.update([0], np.ones((1, 9), np.float32))
        with pytest.raises(ValueError, match="update indices must be in"):
            h.update([8], np.ones((1, 8), np.float32))
        with pytest.raises(ValueError, match="indices for"):
            h.update([0, 1], np.ones((1, 8), np.float32))
        h.update(np.empty(0, np.int64), np.empty((0, 8), np.float32))


class TestArrowCorpusHandle:
    """Arrow surface with a resident Corpus: upload/prepare once, serve
    Arrow queries many times (Corpus.from_arrow + handle dispatch)."""

    def test_topk_arrow_with_handle_matches_oneshot(self):
        rng = np.random.default_rng(171)
        q = rng.standard_normal((6, 24)).astype(np.float32)
        c = rng.standard_normal((200, 24)).astype(np.float32)
        qa, ca = fsl(q, np.float32), fsl(c, np.float32)
        h = pmt.Corpus.from_arrow(ca)
        assert h.dtype == np.float32 and (h.n, h.dim) == (200, 24)
        out_h = pmt.topk_arrow(qa, h, k=5)
        out_a = pmt.topk_arrow(qa, ca, k=5)
        assert out_h.to_pylist() == out_a.to_pylist()
        # masks and metrics ride through
        mask = rng.random(200) < 0.5
        out_m = pmt.topk_arrow(qa, h, k=4, metric="euclidean",
                               mask=pa.array(mask))
        for row in out_m.to_pylist():
            assert all(mask[m["index"]] for m in row)

    def test_matmul_arrow_with_handle(self):
        rng = np.random.default_rng(172)
        q = rng.standard_normal((4, 16)).astype(np.float32)
        c = rng.standard_normal((30, 16)).astype(np.float32)
        h = pmt.Corpus.from_arrow(fsl(c, np.float32))
        out = pmt.matmul_arrow(fsl(q, np.float32), h)
        np.testing.assert_allclose(
            np.array(out.to_pylist()), q @ c.T, rtol=1e-5, atol=1e-5)
        flat = pmt.matmul_arrow(fsl(q, np.float32), h, flatten=True)
        assert len(flat) == 4 * 30
        # empty queries -> typed empty, not an error
        empty = pa.array([], type=pa.list_(pa.float32()))
        assert len(pmt.topk_arrow(empty, h, k=3)) == 0

    def test_from_arrow_storage_modes_and_mutation(self):
        rng = np.random.default_rng(173)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((80, 16)).astype(np.float32)
        h = pmt.Corpus.from_arrow(fsl(c, np.float32), storage="int8",
                                  capacity=120)
        i0, _ = h.topk(q, 3)
        h.add(q * 2.0)
        out = pmt.topk_arrow(fsl(q, np.float32), h, k=1)
        assert [r[0]["index"] for r in out.to_pylist()] == [80, 81, 82]

    def test_from_arrow_list_column_f64(self):
        # plain List (not FixedSizeList) f64 column -> copy path, f64
        c = pa.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
        h = pmt.Corpus.from_arrow(c)
        assert h.dtype == np.float64
        out = pmt.topk_arrow(pa.array([[1.0, 0.0]]), h, k=1)
        assert out.to_pylist()[0][0]["index"] == 0


class TestSeventhReviewRegressions:
    def test_int8_mutation_after_two_k_regimes(self):
        """k=10 and k=100 share ONE bias-rows array across prepared keys;
        add/update must donate it exactly once and re-point every key
        (it used to be donated per key -> deleted-array poison)."""
        rng = np.random.default_rng(181)
        q = rng.standard_normal((4, 32)).astype(np.float32)
        c = rng.standard_normal((300, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="int8", capacity=400)
        h.topk(q, 5)
        h.topk(q, 40)                    # same prep serves every k
        assert len(h._prepared) == 1
        h.update([7], q[:1] * 3.0)       # must not touch a deleted array
        i, _ = h.topk(q[:1], 1)
        assert i[0, 0] == 7
        h.add(q[1:2] * 3.0)
        i2, _ = h.topk(q[1:2], 1)
        assert i2[0, 0] == 300
        # both regimes still serve correctly and share one bias array
        i3, _ = h.topk(q, 40)
        assert i3.shape == (4, 40)
        (cp, _), = h._prepared.values()
        assert cp is h._device

    def test_update_duplicate_indices_rejected(self):
        c = np.eye(8, dtype=np.float32)
        h = pmt.Corpus(c)
        with pytest.raises(ValueError, match="unique"):
            h.update([2, 2], np.ones((2, 8), np.float32))

    def test_matmul_arrow_handle_empty_dtype_promotion(self):
        c = np.eye(4, dtype=np.float32)
        h = pmt.Corpus(c)
        empty64 = pa.array([], type=pa.list_(pa.float64()))
        out_h = pmt.matmul_arrow(empty64, h)
        out_a = pmt.matmul_arrow(empty64, fsl(c, np.float32))
        assert out_h.type == out_a.type  # both promote to f64

    def test_config_with_handle_rejected(self):
        c = np.eye(4, dtype=np.float32)
        h = pmt.Corpus(c)
        q = pa.array([[1.0, 0.0, 0.0, 0.0]])
        with pytest.raises(ValueError, match="handle's own config"):
            pmt.topk_arrow(q, h, k=1, config=pmt.SearchConfig())
        with pytest.raises(ValueError, match="handle's own config"):
            pmt.matmul_arrow(q, h, config=pmt.SearchConfig())


class TestTraceableOps:
    """topk_jax / matmul_jax: device arrays in and out, fully jittable —
    search composed into a larger jit program (embed -> search) with no
    host round-trip."""

    def test_topk_jax_inside_user_jit(self):
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(191)
        W = jnp.asarray(rng.standard_normal((12, 32)).astype(np.float32))
        c = jnp.asarray(rng.standard_normal((300, 32)).astype(np.float32))

        @jax.jit
        def embed_and_search(x, c):
            emb = jnp.tanh(x @ W)             # a tiny "embedding model"
            v, i = pmt.topk_jax(emb, c, 5, "cosine")
            return v, i

        x = jnp.asarray(rng.standard_normal((7, 12)).astype(np.float32))
        v, i = embed_and_search(x, c)
        assert v.shape == (7, 5) and i.shape == (7, 5)
        emb = np.tanh(np.asarray(x) @ np.asarray(W))
        i0, v0 = pmt.topk(emb, np.asarray(c), 5)
        np.testing.assert_array_equal(np.asarray(i), i0)

    def test_topk_jax_bigk_inside_user_jit(self):
        """128 < k <= 1024 composes under an outer jit too: the big-k
        gstack build, its XLA finish, and the lax.cond exact re-run all
        trace (round 4)."""
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(193)
        c = jnp.asarray(rng.standard_normal((900, 24)).astype(np.float32))

        @jax.jit
        def search(q, c):
            return pmt.topk_jax(q, c, 200, "cosine")

        q = jnp.asarray(rng.standard_normal((4, 24)).astype(np.float32))
        v, i = search(q, c)
        assert v.shape == (4, 200) and i.shape == (4, 200)
        i0, v0 = pmt.topk(np.asarray(q), np.asarray(c), 200)
        assert (np.asarray(i) == i0).mean() > 0.97

    def test_matmul_jax_grad_flows(self):
        # the dense op is differentiable — usable inside training losses
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(192)
        q = jnp.asarray(rng.standard_normal((4, 16)).astype(np.float32))
        c = jnp.asarray(rng.standard_normal((9, 16)).astype(np.float32))

        def loss(q):
            return jnp.sum(pmt.matmul_jax(q, c) ** 2)

        g = jax.grad(loss)(q)
        g0 = 2.0 * (np.asarray(q) @ np.asarray(c).T) @ np.asarray(c)
        np.testing.assert_allclose(np.asarray(g), g0, rtol=1e-3, atol=1e-3)


class TestInt4Storage:
    """Corpus(storage="int4"): nibble-packed codes + f32 scales — an
    eighth of the f32 HBM/upload/disk bytes (capacity tier; recall@10
    ~0.8-0.9 on random data, higher on real embeddings)."""

    def _dequant(self, c):
        from polars_matmul_tpu.api.search import (
            _quantize_rows_int4_np, _unpack_int4_np)
        from polars_matmul_tpu.kernels.fused_topk import feature_geometry

        ck, dpp, _ = feature_geometry(c.shape[1])
        packed, scales = _quantize_rows_int4_np(
            np.asarray(c, np.float32), ck, dpp)
        codes = _unpack_int4_np(packed, ck, c.shape[1])
        return codes.astype(np.float32) * scales[:, None]

    def test_matches_dequantized_oracle_all_metrics(self):
        rng = np.random.default_rng(201)
        q = rng.standard_normal((10, 48)).astype(np.float32)
        c = rng.standard_normal((400, 48)).astype(np.float32)
        h = pmt.Corpus(c, storage="int4")
        cdeq = self._dequant(c)
        for metric in ("cosine", "dot", "euclidean"):
            i1, v1 = h.topk(q, 6, metric)
            i0, v0 = pmt.topk(q, cdeq, 6, metric)
            assert (i1 == i0).mean() > 0.97, (metric, (i1 == i0).mean())
            np.testing.assert_allclose(v1, v0, rtol=2e-3, atol=2e-3)
        # prepared forms alias the packed buffer (half the int8 width)
        for cp, cb in h._prepared.values():
            assert cp is h._device
        assert h._device.shape[1] == 64  # dpp=128 -> 64 packed bytes

    def test_recall_and_fallbacks(self):
        rng = np.random.default_rng(202)
        q = rng.standard_normal((30, 128)).astype(np.float32)
        c = rng.standard_normal((2000, 128)).astype(np.float32)
        h = pmt.Corpus(c, storage="int4")
        i1, _ = h.topk(q, 10)
        i0, _ = pmt.topk(q, c, 10)
        rec = np.mean([len(set(i1[r]) & set(i0[r]))/10 for r in range(30)])
        assert rec > 0.7, rec
        # large k stays on the int4 codes (the hi|lo query split differs
        # from the dense f32 product in the last bits, so near-ties may
        # swap)
        i2, _ = h.topk(q, 200)
        i3, _ = pmt.topk(q, self._dequant(c), 200)
        assert (i2 == i3).mean() > 0.97
        i4, v4 = h.topk(q, 1100)
        i5, v5 = pmt.topk(q, self._dequant(c), 1100)
        assert (i4 == i5).mean() > 0.97
        np.testing.assert_allclose(v4, v5, rtol=1e-4, atol=1e-4)
        out = h.matmul(q[:3])
        np.testing.assert_allclose(out, q[:3] @ self._dequant(c).T,
                                   rtol=1e-4, atol=1e-4)

    def test_mutations_and_persistence(self, tmp_path):
        rng = np.random.default_rng(203)
        q = rng.standard_normal((3, 32)).astype(np.float32)
        c = rng.standard_normal((100, 32)).astype(np.float32)
        h = pmt.Corpus(c, storage="int4", capacity=200)
        h.topk(q, 3)
        h.add(q * 5.0)
        i, v = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [100, 101, 102])
        h.update([7], q[:1] * 4.0)
        i2, _ = h.topk(q[:1], 2)
        assert set(i2[0].tolist()) == {7, 100}
        h.delete([100])
        i3, _ = h.topk(q[:1], 1)
        assert i3[0, 0] == 7
        p = tmp_path / "c4.npz"
        h.save(p)
        # file stores PACKED nibbles: n * dpp/2 bytes + scales
        with np.load(p) as z:
            assert z["data"].dtype == np.int8 and z["data"].shape[1] == 64
        h2 = pmt.Corpus.load(p, capacity=200)
        ia, va = h2.topk(q[:1], 1)
        assert ia[0, 0] == 7 and h2.deleted_count == 1
        # requantization after the dequant round-trip is exact
        np.testing.assert_array_equal(np.asarray(h2._device)[:103],
                                      np.asarray(h._device)[:103])

    def test_high_dim_chunked(self):
        rng = np.random.default_rng(204)
        dim = 8600                          # nk > 1: per-chunk packing
        q = (rng.standard_normal((3, dim)) / 90).astype(np.float32)
        c = (rng.standard_normal((50, dim)) / 90).astype(np.float32)
        h = pmt.Corpus(c, storage="int4")
        i, v = h.topk(q, 4)
        assert len(h._prepared) == 1        # kernel path (no f32 blowup)
        i0, _ = pmt.topk(q, self._dequant(c), 4)
        assert (i == i0).mean() > 0.9

    # (mesh + int4 storage is covered in test_parallel.py: nibble-packed
    # shards + sharded scales, searched with the same int4c kernel mode)


class TestEighthReviewRegressions:
    def test_int4_growth_keeps_shared_invariant(self):
        """Growth past capacity must keep the buffer a 4096-row multiple
        (it used to round only for int8, silently demoting int4 to the
        copy path forever and re-prepping O(n) per mutation)."""
        rng = np.random.default_rng(211)
        q = rng.standard_normal((3, 16)).astype(np.float32)
        c = rng.standard_normal((100, 16)).astype(np.float32)
        h = pmt.Corpus(c, storage="int4", capacity=100)
        h.topk(q, 3)
        h.add(rng.standard_normal((200, 16)).astype(np.float32))
        assert h._device.shape[0] % 4096 == 0
        h.topk(q, 3)                          # rebuild prep
        (cp, _), = list(h._prepared.values())
        assert cp is h._device                # shared path regained
        h.add(q * 5.0)                        # splice, not rebuild
        (cp2, _), = list(h._prepared.values())
        assert cp2 is h._device
        i, _ = h.topk(q, 1)
        np.testing.assert_array_equal(i[:, 0], [300, 301, 302])

    def test_prepacked_int4_constructor(self):
        from polars_matmul_tpu.api.search import _quantize_rows_int4_np
        from polars_matmul_tpu.kernels.fused_topk import feature_geometry

        rng = np.random.default_rng(212)
        q = rng.standard_normal((3, 24)).astype(np.float32)
        c = rng.standard_normal((80, 24)).astype(np.float32)
        ck, dpp, _ = feature_geometry(24)
        packed, scales = _quantize_rows_int4_np(c, ck, dpp)
        h = pmt.Corpus(packed, storage="int4", scales=scales, dim=24)
        h0 = pmt.Corpus(c, storage="int4")
        i, v = h.topk(q, 4)
        i0, v0 = h0.topk(q, 4)
        np.testing.assert_array_equal(i, i0)
        np.testing.assert_allclose(v, v0, rtol=0, atol=0)
        with pytest.raises(ValueError, match="require scales"):
            pmt.Corpus(packed, storage="int4", dim=24)
        with pytest.raises(ValueError, match="packed width"):
            # dim=200 pads to 256 (width 128), not this buffer's 64
            pmt.Corpus(packed, storage="int4", scales=scales, dim=200)
        with pytest.raises(ValueError, match="only meaningful"):
            pmt.Corpus(c, dim=24)

    def test_shard_corpus_int4_requires_dim(self):
        import jax

        jax.config.update("jax_platforms", "cpu")
        if len(jax.devices()) < 8:
            pytest.skip("needs the CPU mesh")
        mesh = pmt.make_mesh(n_data=1, n_corpus=8)
        packed = np.zeros((16, 8), np.int8)
        with pytest.raises(ValueError, match="requires dim"):
            pmt.shard_corpus(packed, mesh, scales=np.ones(16, np.float32),
                             storage="int4")
