"""Engine orchestration: the two public operations on Arrow / NumPy data.

This layer owns what the reference's ``matmul_impl`` / ``topk_impl`` own
(src/matmul.rs:295-519): dtype dispatch (both-f32 rule), empty-input fast
returns, dimension-mismatch errors, k clamping, and output assembly — with
the compute dispatched to the XLA scan in ``kernels.fused_topk`` (f32 and
the storage tiers) or the f64 reference path, optionally across a device
mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np

from ..config import SearchConfig, resolve, ensure_x64
from ..ops.metrics import Metric
from ..utils.profiling import annotate, call_stats

ArrayLike = Union[np.ndarray, "jax.Array"]  # noqa: F821


def _to_jax(x: np.ndarray, dtype: np.dtype):
    import jax

    if np.dtype(dtype) == np.float64:
        ensure_x64()
    import jax.numpy as jnp

    return jnp.asarray(x, dtype=dtype)


def _host_owned(x) -> np.ndarray:
    """Host-OWNED numpy result: np.asarray of a jax array is a zero-copy
    view of jax-owned memory on CPU backends, which a later dispatch can
    recycle under the caller (see _unpack_pair).  Copy unless numpy
    already owns the bytes."""
    a = np.asarray(x)
    return a if a.flags["OWNDATA"] else a.copy()


def _validate_pair(q: np.ndarray, c: np.ndarray) -> None:
    if q.ndim != 2 or c.ndim != 2:
        raise ValueError("Embeddings must be 2-D (n_rows, dim) matrices")
    if q.shape[1] != c.shape[1]:
        raise ValueError(
            f"Dimension mismatch: left has {q.shape[1]} dimensional vectors, "
            f"right has {c.shape[1]} dimensional vectors"
        )
    if q.shape[1] == 0:
        raise ValueError("Zero-dimensional vectors")


def compute_dtype(q_dtype, c_dtype) -> np.dtype:
    """Both-f32 rule (reference matmul.rs:13-19,308,427)."""
    if np.dtype(q_dtype) == np.float32 and np.dtype(c_dtype) == np.float32:
        return np.dtype(np.float32)
    return np.dtype(np.float64)


def matmul(
    queries: ArrayLike,
    corpus: ArrayLike,
    *,
    config: Optional[SearchConfig] = None,
) -> np.ndarray:
    """All pairwise dot products: (m, n) = Q . C^T, at full precision.

    dtype follows the both-f32 rule; output matches the compute dtype
    (reference matmul_impl, matmul.rs:295-315).  ``config`` is accepted
    for symmetry with ``topk``; the product is always exact.
    """
    from ..kernels.matmul import pairwise_matmul

    q = np.asarray(queries)
    c = np.asarray(corpus)
    if q.shape[0] == 0:
        return np.empty((0, c.shape[0]), dtype=compute_dtype(q.dtype, c.dtype))
    if c.shape[0] == 0:
        raise ValueError("Empty series")
    _validate_pair(q, c)
    dt = compute_dtype(q.dtype, c.dtype)
    with annotate("pmm.matmul"):
        out = pairwise_matmul(_to_jax(q, dt), _to_jax(c, dt))
    return _host_owned(out)


def topk(
    queries: ArrayLike,
    corpus: ArrayLike,
    k: int,
    metric: Union[str, Metric] = "cosine",
    *,
    mask: Optional[ArrayLike] = None,
    config: Optional[SearchConfig] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused top-k search.

    Returns ``(indices (m, k') u32, scores (m, k') f64)`` with
    ``k' = min(k, n_corpus)`` (reference matmul.rs:443,463), rows sorted
    best-first, ties broken lowest-index-first.

    ``mask`` (n_corpus,) bool enables filtered search (no reference
    analog): excluded rows never match; slots beyond the number of
    matching rows carry sentinel scores (-inf similarity / +inf distance).
    """
    metric = Metric.parse(metric)
    q = np.asarray(queries)
    c = np.asarray(corpus)
    if q.shape[0] == 0:
        return (np.empty((0, 0), np.uint32), np.empty((0, 0), np.float64))
    if c.shape[0] == 0:
        raise ValueError("Empty series")
    _validate_pair(q, c)
    mk = _validate_mask(mask, c.shape[0])
    kk = min(int(k), c.shape[0])
    if kk <= 0:
        # k=0 yields empty match lists (reference quickselect truncates to 0)
        return (
            np.empty((q.shape[0], 0), np.uint32),
            np.empty((q.shape[0], 0), np.float64),
        )
    dt = compute_dtype(q.dtype, c.dtype)
    import time as _time

    t0 = _time.perf_counter()
    mkj = None if mk is None else _to_jax(mk, np.dtype(bool))
    packed = _packed_topk(
        _to_jax(q, dt), _to_jax(c, dt), kk, metric, resolve(config), mkj
    )
    v, i = _unpack_pair(packed, kk)
    call_stats("topk", m=q.shape[0], n=c.shape[0], dim=q.shape[1], k=kk,
               dtype=dt, wall_s=_time.perf_counter() - t0)
    return i.astype(np.uint32), v.astype(np.float64)


def _validate_mask(mask, n: int):
    if mask is None:
        return None
    m = np.asarray(mask)
    if m.shape != (n,):
        raise ValueError(
            f"mask must have shape ({n},) matching the corpus rows, "
            f"got {m.shape}"
        )
    return m.astype(bool)


def _packed_oneshot_fn(k: int, metric: Metric, cfg: SearchConfig,
                       masked: bool):  # masked: cache-key arity marker
    """One jitted program: corpus prep + scan + finalize + pack (one
    dispatch per call).  Cached per (k, metric, cfg, masked); jit handles
    shape polymorphism beneath each entry.
    """
    import jax

    from ..kernels.fused_topk import fused_topk

    @jax.jit
    def run(qj, cj, *m):
        vals, idx = fused_topk(qj, cj, k, metric,
                               mask=m[0] if m else None, config=cfg)
        return _pack_pair(vals, idx)

    return run


def _packed_prepared_fn(k: int, metric: Metric, cfg: SearchConfig,
                        masked: bool):  # masked: cache-key marker
    """One jitted program for the prepared path: query prep + scan +
    euclidean finalize + pack (single dispatch per call)."""
    import jax

    from ..kernels.fused_topk import fused_topk_prepared

    @jax.jit
    def run(qj, cp, cbp, *m):
        vals, idx = fused_topk_prepared(
            qj, cp, cbp, k, metric, mask=m[0] if m else None, config=cfg,
        )
        return _pack_pair(vals, idx)

    return run


def _cached_fn(cache: dict, key, factory, max_entries: int = 64):
    """Get-or-create with simple FIFO eviction (compiled executables are
    heavy; bound matches the shard_map program cache in parallel/)."""
    fn = cache.get(key)
    if fn is None:
        if len(cache) >= max_entries:
            cache.pop(next(iter(cache)))
        fn = factory(*key)
        cache[key] = fn
    return fn


_ONESHOT_CACHE: dict = {}


@functools.lru_cache(maxsize=64)
def _prep_chunk_fn(metric_v: str, precision: str):
    """Jitted row-chunk prep, cached per prepared-form key so Corpus.add
    compiles each splice program once.  int8c preps take (codes, scales)."""
    import jax

    from ..kernels.fused_topk import prepare_corpus

    def run(chunk, *rest):
        return prepare_corpus(
            chunk, Metric.parse(metric_v), precision=precision,
            scales=rest[0] if rest else None,
        )

    return jax.jit(run)


@functools.lru_cache(maxsize=1)
def _splice_fns():
    """Donated dynamic_update_slice wrappers: Corpus.add splices rows /
    bias columns IN PLACE (input-output aliasing) instead of copying the
    whole buffer per add — an eager dynamic_update_slice cannot alias, so
    without donation every add costs O(corpus) HBM traffic and a 2x
    transient, which would OOM a corpus sized to fit HBM."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0,))
    def rows(buf, block, r0):
        return jax.lax.dynamic_update_slice(buf, block, (r0, jnp.int32(0)))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def cols(buf, block, c0):
        return jax.lax.dynamic_update_slice(buf, block, (jnp.int32(0), c0))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def vec(buf, block, i0):
        return jax.lax.dynamic_update_slice(buf, block, (i0,))

    return rows, cols, vec


@functools.lru_cache(maxsize=1)
def _scatter_fns():
    """Donated scatter wrappers for Corpus.update (arbitrary-index row
    replacement), same in-place rationale as _splice_fns."""
    import jax

    @functools.partial(jax.jit, donate_argnums=(0,))
    def rows(buf, block, idx):
        return buf.at[idx].set(block)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def cols(buf, block, idx):
        return buf.at[:, idx].set(block)

    return rows, cols


@functools.lru_cache(maxsize=32)
def _quant_bias_chunk_fn(metric_v: str, storage: str):
    """Jitted (2, m) scale|bias columns for freshly written quantized rows
    (all valid), spliced into a shared-storage prepared form by
    Corpus.add/update."""
    import jax

    from ..kernels.fused_topk import prepare_int4_bias, prepare_int8_bias

    bias_fn = prepare_int4_bias if storage == "int4" else prepare_int8_bias

    def run(codes, scales):
        return bias_fn(codes, scales, Metric.parse(metric_v),
                       codes.shape[0])

    return jax.jit(run)


def _quantize_rows_int4_np(c: np.ndarray, ck: int, dpp: int):
    """Host-side per-row symmetric int4 quantization, nibble-packed per
    K-chunk (layout contract: kernels.fused_topk.quantize_int4),
    row-chunked so the f32/int32 temporaries stay bounded — this is the
    capacity tier, aimed at corpora too big to hold twice.  Dispatches
    to the fused one-pass C++ kernel for f32 input (bit-identical)."""
    from ..interop.native import native_quantize_i4

    if c.dtype == np.float32:
        out = native_quantize_i4(c, ck, dpp)  # wrapper owns the contig copy
        if out is not None:
            return out
    n, dim = c.shape
    packed = np.empty((n, dpp // 2), np.int8)
    scales = np.empty(n, np.float32)
    step = max(1, (64 << 20) // max(dpp * 4, 1))
    for r0 in range(0, n, step):
        blk = np.asarray(c[r0:r0 + step], dtype=np.float32)
        amax = np.abs(blk).max(axis=1)
        sc = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
        codes = np.clip(np.rint(blk / sc[:, None]), -7, 7).astype(np.int32)
        codes = np.pad(codes, ((0, 0), (0, dpp - dim)))
        ch = codes.reshape(codes.shape[0], dpp // ck, ck)
        packed[r0:r0 + step] = ((ch[:, :, : ck // 2] & 0xF)
                                | ((ch[:, :, ck // 2:] & 0xF) << 4)
                                ).astype(np.int8).reshape(
                                    codes.shape[0], dpp // 2)
        scales[r0:r0 + step] = sc
    return packed, scales


def _unpack_int4_np(packed: np.ndarray, ck: int, dim: int) -> np.ndarray:
    """Host-side inverse of the pack layout -> int codes (n, dim)."""
    n = packed.shape[0]
    p32 = packed.astype(np.int32).reshape(n, -1, ck // 2)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = (((p32 >> 4) & 0xF) ^ 8) - 8
    return np.concatenate([lo, hi], axis=2).reshape(n, -1)[:, :dim]


def _round_up_rows(n: int, m: int = 4096) -> int:
    """Quantized shared-storage row padding: buffers grow in whole
    4096-row units, so a small add rarely reallocates."""
    return ((n + m - 1) // m) * m


def _quantize_rows_np(c: np.ndarray):
    """Host-side per-row symmetric int8 quantization.  Dispatches to the
    fused one-pass C++ kernel for f32 input (bit-identical results; the
    NumPy path is three full-matrix passes and is host-bandwidth-bound
    at ingestion scale), falling back to a row-chunked NumPy
    implementation so the f32 temp stays bounded.  Mirrors
    kernels.fused_topk.quantize_int8 — the int8 corpus uploads at a
    quarter of the f32 bytes."""
    from ..interop.native import native_quantize_i8

    if c.dtype == np.float32:
        out = native_quantize_i8(c)  # wrapper owns the contig copy
        if out is not None:
            return out
    n, dim = c.shape
    codes = np.empty((n, dim), np.int8)
    scales = np.empty(n, np.float32)
    step = max(1, (64 << 20) // max(dim * 4, 1))
    for r0 in range(0, n, step):
        blk = np.asarray(c[r0:r0 + step], dtype=np.float32)
        amax = np.abs(blk).max(axis=1)
        s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        codes[r0:r0 + step] = np.rint(blk / s[:, None]).astype(np.int8)
        scales[r0:r0 + step] = s
    return codes, scales


def _packed_topk(qj, cj, k: int, metric: Metric, cfg: SearchConfig, mask):
    """Single-dispatch topk returning the packed host array."""
    key = (k, metric, cfg, mask is not None)
    fn = _cached_fn(_ONESHOT_CACHE, key, _packed_oneshot_fn)
    args = (qj, cj) if mask is None else (qj, cj, mask)
    with annotate(f"pmm.topk.{metric.value}"):
        return np.asarray(fn(*args))


def _pack_pair(vals, idx):
    """Pack (vals, idx) into one device array so results come back to the
    host in a single transfer.

    The f32 path packs in INTEGER space (scores bitcast to int32), never
    the other way around: small int32 indices bitcast to f32 are
    denormals, which a float pipeline may flush to zero.
    """
    import jax
    import jax.numpy as jnp

    if vals.dtype == jnp.float32:
        return jnp.concatenate(
            [jax.lax.bitcast_convert_type(vals, jnp.int32), idx], axis=1
        )
    return jnp.concatenate([vals, idx.astype(vals.dtype)], axis=1)


def _unpack_pair(packed: np.ndarray, k: int):
    """Split a packed result into host-OWNED (vals, idx) arrays.

    ``packed`` is np.asarray of a jax array — a zero-copy VIEW of
    jax-owned memory on CPU backends.  Returned results must not alias
    it: once the jax array is unreferenced its buffer can be recycled by
    a later dispatch (donated in-place updates make this routine), and a
    user-held view would silently corrupt.  Both slices below copy.
    """
    if packed.dtype == np.int32:
        # .copy(), not ascontiguousarray: a single-row slice is already
        # contiguous and would be returned as a view.
        vals = packed[:, :k].copy().view(np.float32)
        idx = packed[:, k:].copy()
    else:
        vals = packed[:, :k].copy()
        idx = packed[:, k:].astype(np.int64)  # astype allocates
    return vals, idx


def _fetch_topk(vals, idx, k: int):
    """Single-transfer device->host fetch of a top-k result pair."""
    import jax

    packed = np.asarray(jax.jit(_pack_pair)(vals, idx))
    return _unpack_pair(packed, k)


def _scatter_rows_sharded(sc, storage: str, dim: int, r: np.ndarray,
                          idx_np: np.ndarray):
    """Scatter f32 rows ``r`` into a ShardedCorpus at global array
    POSITIONS ``idx_np`` (storage-native), patching every cached
    per-shard prepared form through donated programs.

    Shared by ``Corpus`` mesh update/add (where positions == row ids
    under block partitioning) and ``ClusteredCorpus`` mesh update (where
    positions are the ids' permuted slots, ``layout.row_pos[ids]``) —
    the per-shard prepared forms are layout-agnostic, so the same patch
    applies.  Positions must be unique and within the existing padded
    height (no growth here).
    """
    quantized = storage in ("int8", "int4")
    m = r.shape[0]
    put_rows, put_cols = _scatter_fns()
    idx_j = _to_jax(idx_np.astype(np.int32), np.dtype(np.int32))

    if quantized:
        if storage == "int4":
            from ..kernels.fused_topk import feature_geometry

            ck, dpp, _ = feature_geometry(dim)
            codes_np, scales_np = _quantize_rows_int4_np(r, ck, dpp)
        else:
            codes_np, scales_np = _quantize_rows_np(r)
        codes_np = np.pad(
            codes_np,
            ((0, 0), (0, sc.data.shape[1] - codes_np.shape[1])))
        rj = _to_jax(codes_np, np.dtype(np.int8))
        scales_j = _to_jax(scales_np, np.dtype(np.float32))
        sc.scales = put_rows(sc.scales, scales_j, idx_j)
        sc._f32_view = None
        # Alias discipline (same as the single-device path): every
        # shared-storage prepared form holds the SAME code buffer,
        # which must be donated exactly once with no surviving
        # references; cbp rows are deduped by identity because
        # different k-regime keys share one bias operand.
        shared = {}
        for key in list(sc._prepared):
            entry = sc._prepared.pop(key)
            cp_e, cbp_e = entry
            aliased = cp_e is sc.data
            del entry, cp_e
            if not aliased or cbp_e.shape[1] != sc.data.shape[0]:
                continue  # copy-geometry prep: rebuild lazily
            if id(cbp_e) in shared:
                shared[id(cbp_e)][1].append(key)
            else:
                shared[id(cbp_e)] = (cbp_e, [key])
        sc.data = put_rows(sc.data, rj, idx_j)
        for cbp_e, keys in list(shared.values()):
            cbc = _quant_bias_chunk_fn(keys[0][0], storage)(rj, scales_j)
            new_cbp = put_cols(cbp_e, cbc, idx_j)
            for key in keys:
                sc._prepared[key] = (sc.data, new_cbp)
        return

    import jax.numpy as jnp

    buf_dt = sc.data.dtype
    rj32 = _to_jax(r, np.dtype(np.float32))
    # f64 buffers take the rows at full precision (an f32 round trip
    # would launder the update through f32); bf16/f32 cast from f32
    if np.dtype(buf_dt) == np.float64:
        rj = _to_jax(r, np.dtype(np.float64))
    else:
        rj = rj32.astype(buf_dt) if buf_dt != jnp.float32 else rj32
    prep_src = rj if storage == "bf16" else rj32
    sc._f32_view = None
    sc.data = put_rows(sc.data, rj, idx_j)
    # Per-shard prepared forms keep the shards' row geometry, so global
    # position g is prepared row g as well.
    for key in list(sc._prepared):
        cp_e, cbp_e = sc._prepared.pop(key)
        cpc, cbc = _prep_chunk_fn(*key)(prep_src)
        cp_e = put_rows(cp_e, cpc[:m], idx_j)
        cbp_e = put_cols(cbp_e, cbc[:, :m], idx_j)
        sc._prepared[key] = (cp_e, cbp_e)


class Corpus:
    """Device-resident corpus handle (new capability vs the reference).

    The reference re-marshals the corpus on every call (SURVEY.md §5
    checkpoint/resume: the one stateful thing worth adding).  ``Corpus``
    uploads (and optionally shards across a mesh axis) once; subsequent
    ``topk`` / ``matmul`` calls only move the queries.
    """

    def __init__(
        self,
        embeddings: ArrayLike,
        *,
        mesh=None,
        storage: str = "f32",
        scales: Optional[ArrayLike] = None,
        dim: Optional[int] = None,
        capacity: Optional[int] = None,
        config: Optional[SearchConfig] = None,
    ):
        """``storage="bf16"`` keeps the device corpus in bfloat16 (half the
        HBM; scores then carry the ~2^-9 storage quantization — opt-in).
        Composes with ``mesh``: shards are stored bf16 and searched with
        the same "bf16c" tier as single-device bf16 handles.

        ``storage="int8"`` keeps per-row symmetric int8 codes + one f32
        scale per row (a quarter of the f32 HBM, and the ingestion upload
        moves a quarter of the bytes).  The scan converts each step's codes
        to bf16 (int8 values are bf16-exact) and folds the dequant scale
        into the epilogue, so scores match the *dequantized* corpus to
        ~1e-5 and recall@10 vs exact f32 is ~0.99 on random data.
        Quantization happens once at ingestion; every metric reuses the
        same codes (for cosine the scale cancels against the row norm).
        Composes with ``mesh=``: int8 shards + sharded scales, searched
        with the same "int8c" tier (4x the corpus rows per device).
        Pre-quantized corpora skip that step: pass int8 ``embeddings``
        (the codes) with ``scales`` (n,) — the contract is
        ``row ~= codes * scale`` (this is also what ``Corpus.load``
        uses, so saved int8 corpora reload without requantizing).

        ``capacity`` pre-reserves device rows for ``add()`` (single-device
        only): adds within capacity are in-place row writes into the
        prepared buffers — the compiled search program's shapes never
        change, so growth costs zero recompilation."""
        cfg = resolve(config)
        c = np.asarray(embeddings)
        if c.ndim != 2:
            raise ValueError("Embeddings must be 2-D (n_rows, dim) matrices")
        if c.shape[0] == 0:
            raise ValueError("Empty series")
        if c.shape[1] == 0:
            raise ValueError("Zero-dimensional vectors")
        if storage not in ("f32", "bf16", "int8", "int4"):
            raise ValueError(f"Unknown storage mode: {storage!r}")

        if np.dtype(c.dtype) == np.int8 and storage not in ("int8",
                                                             "int4"):
            raise ValueError(
                "int8 embeddings (pre-quantized codes) require "
                "storage='int8' (or storage='int4' for nibble-packed "
                "codes with dim=)"
            )
        prepacked_int4 = (storage == "int4"
                          and np.dtype(c.dtype) == np.int8)
        if prepacked_int4:
            from ..kernels.fused_topk import feature_geometry

            if scales is None or dim is None:
                raise ValueError(
                    "pre-packed int4 codes require scales=(n,) and the "
                    "original dim= (the packed width is ambiguous)"
                )
            _, dpp_chk, _ = feature_geometry(int(dim))
            if c.shape[1] * 2 != dpp_chk:
                raise ValueError(
                    f"packed width {c.shape[1]} does not match dim={dim} "
                    f"(expected {dpp_chk // 2})"
                )
            scales = np.asarray(scales, dtype=np.float32).reshape(-1)
            if scales.shape[0] != c.shape[0]:
                raise ValueError(
                    f"scales must have shape ({c.shape[0]},), "
                    f"got {scales.shape}"
                )
        elif dim is not None:
            raise ValueError(
                "dim= is only meaningful with pre-packed int4 codes"
            )
        if storage == "int8" and np.dtype(c.dtype) == np.int8:
            if scales is None:
                raise ValueError(
                    "pre-quantized int8 embeddings require scales=(n,) "
                    "with row ~= codes * scale"
                )
            scales = np.asarray(scales, dtype=np.float32).reshape(-1)
            if scales.shape[0] != c.shape[0]:
                raise ValueError(
                    f"scales must have shape ({c.shape[0]},), "
                    f"got {scales.shape}"
                )
        elif scales is not None and not prepacked_int4:
            raise ValueError(
                "scales= is only meaningful with pre-quantized int8 "
                "or pre-packed int4 embeddings"
            )
        self.config = cfg
        self.mesh = mesh
        self.storage = storage
        self.n, self.dim = c.shape
        if prepacked_int4:
            self.dim = int(dim)
        # Device buffers are allocated at `_cap` rows; rows in [n, _cap)
        # are zeros whose prepared bias is -inf (never selectable).
        self._cap = (self.n if capacity is None
                     else max(int(capacity), self.n))
        # Quantized storage (bf16/int8) quantizes the values, so the handle
        # presents f32 semantics regardless of the input float width (f64
        # "precision" on a quantized corpus would be theater and would also
        # divert every query onto the f64 fallback path).
        self.dtype = (np.dtype(np.float32) if storage != "f32"
                      else np.dtype(c.dtype))
        self._quantized = storage in ("int8", "int4")
        dt = self.dtype if self.dtype == np.float32 else np.dtype(np.float64)
        self._scales = None  # int8 storage: (cap,) f32 per-row dequant scale

        if mesh is not None:
            from ..parallel.sharded import shard_corpus

            if storage in ("int8", "int4"):
                if storage == "int4":
                    from ..kernels.fused_topk import feature_geometry

                    if not prepacked_int4:
                        ck, dpp, _ = feature_geometry(self.dim)
                        c, scales = _quantize_rows_int4_np(c, ck, dpp)
                elif np.dtype(c.dtype) != np.int8:
                    c, scales = _quantize_rows_np(c)
                # Host arrays go straight to the shards (device_put with a
                # sharding) — no single-device staging copy.
                self._device = shard_corpus(c, mesh, cfg, scales=scales,
                                            storage=storage, dim=self.dim,
                                            capacity=capacity)
            else:
                dev = _to_jax(c, dt)
                if storage == "bf16":
                    import jax.numpy as jnp

                    dev = dev.astype(jnp.bfloat16)
                self._device = shard_corpus(dev, mesh, cfg,
                                            capacity=capacity)
            if capacity is not None:
                # Every reserved tail row is usable (quantized layouts
                # round the per-shard height up, so there may be more
                # than asked for).
                self._cap = int(self._device.data.shape[0])
        else:
            if storage == "bf16":
                import jax.numpy as jnp

                dev = _to_jax(c, np.dtype(np.float32)).astype(jnp.bfloat16)
            elif storage in ("int8", "int4"):
                # Quantize on host so the upload moves quantized bytes,
                # not f32 (pre-quantized int8 codes pass straight
                # through).  The code buffer is allocated directly in
                # prepared-cp geometry (rows padded to a 4096 multiple,
                # features padded to a multiple of 128; int4 nibble-packs
                # two features per byte): quantized prep never changes the
                # codes, so the prepared form ALIASES this buffer instead
                # of copying it.  Residency = one code buffer, not two.
                from ..kernels.fused_topk import feature_geometry

                ck, dpp, _ = feature_geometry(self.dim)
                if storage == "int4":
                    if not prepacked_int4:
                        c, scales = _quantize_rows_int4_np(c, ck, dpp)
                    width = dpp // 2
                elif np.dtype(c.dtype) != np.int8:
                    c, scales = _quantize_rows_np(c)
                    width = dpp
                else:
                    width = dpp
                rows_pad = _round_up_rows(self._cap)
                codes_p = np.zeros((rows_pad, width), np.int8)
                codes_p[: self.n, : c.shape[1]] = c
                scales_p = np.ones(rows_pad, np.float32)
                scales_p[: self.n] = scales
                dev = _to_jax(codes_p, np.dtype(np.int8))
                self._scales = _to_jax(scales_p, np.dtype(np.float32))
            else:
                dev = _to_jax(c, dt)
            if storage not in ("int8", "int4") and self._cap > self.n:
                import jax.numpy as jnp

                dev = jnp.pad(dev, ((0, self._cap - self.n), (0, 0)))
            self._device = dev
        # Lazy f32 view of a quantized corpus, built only if Corpus.matmul
        # needs dense values; costs the f32 bytes once.
        self._f32_view = None
        # Per-(k, metric, cfg, masked) single-dispatch jitted programs
        # (scan + finalize + result packing in one call).
        self._packed_fns = {}
        # Tombstoned rows (Corpus.delete): excluded from every topk via
        # the mask path — no re-upload or re-prep needed.
        self._tombstones: Optional[np.ndarray] = None
        self._alive_dev = None  # cached device mask for the no-user-mask case
        # Per-(metric, precision) prepared forms (pre-scaled, converted),
        # built lazily on first use: steady-state queries then do zero
        # per-call corpus work on device.
        self._prepared = {}

    def _apply_row_mutation(self, r, put_rows, put_cols, put_vec, pos):
        """Shared in-place mutation core for add()/update(): writes new
        rows into the raw buffer and every cached prepared form through
        donated programs.  ``pos`` is whatever position operand the
        writers take (a splice start row for add, a scatter index vector
        for update)."""
        import jax
        import jax.numpy as jnp

        m = r.shape[0]
        buf_dt = self._device.dtype
        if self._quantized:
            if self.storage == "int4":
                from ..kernels.fused_topk import feature_geometry

                ck, dpp, _ = feature_geometry(self.dim)
                codes_np, scales_np = _quantize_rows_int4_np(r, ck, dpp)
            else:
                codes_np, scales_np = _quantize_rows_np(r)
            # full-width rows: the shared buffer carries 128-padded
            # features (the pad columns are zeros)
            codes_np = np.pad(
                codes_np,
                ((0, 0), (0, self._device.shape[1] - codes_np.shape[1])))
            rj = _to_jax(codes_np, np.dtype(np.int8))
            scales_j = _to_jax(scales_np, np.dtype(np.float32))
            self._scales = put_vec(self._scales, scales_j, pos)
            # Drop every alias of the code buffer BEFORE donating it:
            # shared-storage prepared forms hold the same array, and a
            # donated buffer with surviving references would poison later
            # reads.  Bias rows are deduped by IDENTITY: different
            # k-regime keys share ONE cbp (it is tile-height-independent
            # and always same-metric), which must be donated exactly once
            # and re-pointed under every key.
            shared = {}
            for key in list(self._prepared):
                entry = self._prepared.pop(key)
                cp_e, cbp = entry
                # identity check, same invariant as _scatter_rows_sharded:
                # only preps whose cp IS the shared code buffer may be
                # patched — a copy-geometry prep with a coincidentally
                # matching cbp width must rebuild lazily instead
                aliased = cp_e is self._device
                del entry, cp_e
                if not aliased or cbp.shape[1] != self._device.shape[0]:
                    continue  # copy-path prep: rebuild lazily
                if id(cbp) in shared:
                    shared[id(cbp)][1].append(key)
                else:
                    shared[id(cbp)] = (cbp, [key])
            self._device = put_rows(self._device, rj, pos)
            self._f32_view = None
            for cbp, keys in list(shared.values()):
                cbc = _quant_bias_chunk_fn(
                    keys[0][0], self.storage)(rj, scales_j)
                new_cbp = put_cols(cbp, cbc, pos)
                for key in keys:
                    self._prepared[key] = (self._device, new_cbp)
            return

        rj32 = _to_jax(r, np.dtype(np.float32))
        # f64 buffers take the rows at full precision (an f32 round trip
        # would launder the update through f32); bf16/f32 cast from f32
        if np.dtype(buf_dt) == np.float64:
            rj = _to_jax(r, np.dtype(np.float64))
        else:
            rj = rj32.astype(buf_dt) if buf_dt != jnp.float32 else rj32
        # bf16 storage: derive the prepared write from the STORED
        # (quantized) values, so a write and a later rebuild-from-storage
        # score the rows identically.
        prep_src = rj if self.storage == "bf16" else rj32
        self._device = put_rows(self._device, rj, pos)
        self._f32_view = None

        # Write the new rows into every cached prepared form: prep is
        # row-wise (per-row scaling / bias / conversion), so a chunk prep
        # of just the new rows is exact.
        for key in list(self._prepared):
            cp, cbp = self._prepared.pop(key)
            cpc, cbc = _prep_chunk_fn(*key)(prep_src)
            cp = put_rows(cp, cpc[:m], pos)
            cbp = put_cols(cbp, cbc[:, :m], pos)
            self._prepared[key] = (cp, cbp)

    def _apply_row_mutation_sharded(self, r, idx_np):
        """Mesh analog of _apply_row_mutation for update(): scatter new
        rows into the sharded raw buffer and every cached per-shard
        prepared form through donated programs.  Global row ids ARE
        global array positions (block partitioning pads only at the
        global tail), so the scatter is direct."""
        _scatter_rows_sharded(self._device, self.storage, self.dim, r,
                              idx_np)




    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        where = "mesh" if self.mesh is not None else "device"
        extras = []
        if self._cap > self.n:
            extras.append(f"capacity={self._cap}")
        if self.deleted_count:
            extras.append(f"deleted={self.deleted_count}")
        extra = (", " + ", ".join(extras)) if extras else ""
        return (f"Corpus({self.n}x{self.dim}, storage={self.storage!r}, "
                f"{where}{extra})")

    def add(self, rows: ArrayLike) -> int:
        """Append corpus rows; returns the new row count.

        Dynamic growth with static shapes and masking: device
        buffers are allocated at ``_cap`` rows with a -inf prepared bias
        beyond ``n``, so an add within capacity is a handful of in-place
        row writes — the raw buffer, and each cached prepared form (the
        new rows are scaled/split at chunk granularity and spliced in) —
        and the compiled search program is reused with zero recompilation.
        Exceeding capacity doubles it (one buffer reallocation; prepared
        forms rebuild lazily).  New rows receive indices ``n..n+m-1``.

        Mesh-sharded handles support add when built with ``capacity=``:
        the live row count rides the compiled program as a traced
        operand and growth is the same sharded scatter as ``update``
        (rows land in whichever shard owns the next global positions),
        so in-capacity adds never recompile.  Exceeding a mesh handle's
        capacity raises — re-build (or ``save``/``load``) with more.
        """
        if self.mesh is not None and not self._device.has_capacity:
            raise ValueError(
                "add() on a mesh-sharded Corpus requires the handle to "
                "be built with capacity= (reserved rows are what make "
                "sharded growth an in-place scatter)"
            )
        r = np.asarray(rows)
        if r.ndim != 2 or r.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{r.shape[1] if r.ndim == 2 else r.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        m = r.shape[0]
        if m == 0:
            return self.n
        import jax.numpy as jnp

        new_n = self.n + m
        if self.mesh is not None:
            if new_n > self._cap:
                raise ValueError(
                    f"add() exceeds the mesh handle's capacity "
                    f"({self.n} + {m} > {self._cap}); rebuild (or "
                    f"save/load) with a larger capacity="
                )
            self._apply_row_mutation_sharded(
                r, np.arange(self.n, new_n, dtype=np.int64))
            self._device.n_true = new_n
            self._device._live_mask = None
            if self._tombstones is not None:
                self._tombstones = np.concatenate(
                    [self._tombstones, np.zeros(m, dtype=bool)])
                self._alive_dev = None
            self.n = new_n
            return new_n
        if new_n > self._cap:
            # Grow geometrically; prepared forms rebuild lazily at the new
            # capacity (their row counts change, so in-place is impossible).
            # int8 shared-storage: the buffer is padded to 4096-row
            # multiples, so growth within the existing padding keeps every
            # aliased prepared form valid — only a real reallocation
            # invalidates them.
            new_cap = max(2 * self._cap, new_n)
            grow = ((_round_up_rows(new_cap) if self._quantized
                     else new_cap) - self._device.shape[0])
            if grow > 0:
                self._device = jnp.pad(
                    self._device, ((0, grow), (0, 0)))
                if self._scales is not None:
                    self._scales = jnp.pad(
                        self._scales, (0, grow), constant_values=1.0)
                self._prepared.clear()
                self._f32_view = None
            self._cap = new_cap

        self._apply_row_mutation(r, *_splice_fns(), jnp.int32(self.n))

        if self._tombstones is not None:
            self._tombstones = np.concatenate(
                [self._tombstones, np.zeros(m, dtype=bool)])
            self._alive_dev = None
        self.n = new_n
        return new_n

    @classmethod
    def from_arrow(cls, column, **kwargs) -> "Corpus":
        """Build a resident corpus straight from an Arrow (or polars)
        embedding column — zero-copy extraction for FixedSizeList
        columns, same fallbacks as the one-shot Arrow ops.  Accepts the
        same keyword arguments as the constructor (storage=, mesh=,
        capacity=, config=).  The handle can then serve ``topk_arrow``/
        ``matmul_arrow`` calls (pass it as the ``corpus`` argument) and
        the polars ``.pmm`` namespace directly.
        """
        from ..interop.arrow import extract_embedding_column

        return cls(extract_embedding_column(column), **kwargs)

    def update(self, indices: ArrayLike, rows: ArrayLike) -> None:
        """Overwrite existing corpus rows in place (upsert).

        ``indices`` (m,) keep their values as row ids; ``rows`` (m, dim)
        are the new vectors.  Same in-place machinery as ``add``: the raw
        buffer and every cached prepared form are scatter-updated through
        donated programs, so compiled search programs are reused with
        zero recompilation and no buffer copies.  Updating a tombstoned
        row revives it.  Works on mesh-sharded handles too: the scatter
        routes each row to its owning shard (global ids are global
        positions under block partitioning), and per-shard prepared
        forms are patched in place the same way.
        """
        idx = np.asarray(indices).reshape(-1)
        r = np.asarray(rows)
        if r.ndim != 2 or r.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{r.shape[1] if r.ndim == 2 else r.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        if idx.size != r.shape[0]:
            raise ValueError(
                f"got {idx.size} indices for {r.shape[0]} rows"
            )
        if idx.size == 0:
            return
        if not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"update indices must be integers, got dtype {idx.dtype}"
            )
        if idx.min() < 0 or idx.max() >= self.n:
            raise ValueError(
                f"update indices must be in [0, {self.n}); got "
                f"[{idx.min()}, {idx.max()}]"
            )
        if np.unique(idx).size != idx.size:
            # XLA scatter applies duplicate indices in undefined order,
            # and four separate scatters could each pick different winners
            raise ValueError("update indices must be unique")

        if self.mesh is not None:
            self._apply_row_mutation_sharded(r, idx)
        else:
            scatter_rows, scatter_cols = _scatter_fns()
            idx_j = _to_jax(idx, np.dtype(np.int32))
            self._apply_row_mutation(r, scatter_rows, scatter_cols,
                                     scatter_rows, idx_j)

        if self._tombstones is not None and self._tombstones[idx].any():
            self._tombstones[idx] = False
            self._alive_dev = None

    def save(self, path) -> None:
        """Persist the corpus to ``path`` (.npz): storage-native bytes.

        int8 corpora save their codes + scales (a quarter of the f32
        bytes on disk too); bf16 saves the bf16 payload; tombstones are
        preserved.  Reserved capacity is not persisted (pass
        ``capacity=`` again at load).  Mesh-sharded corpora gather to
        host and can be re-sharded at load with ``mesh=``.
        """
        if self.mesh is None:
            # Trim storage padding (shared-storage buffers carry
            # tile-padded rows and 128-padded features).  int4 keeps its
            # packed width (dim is in the metadata for the unpack).
            width = (self._device.shape[1] if self.storage == "int4"
                     else self.dim)
            data = np.asarray(self._device[: self.n, : width])
            scales = self._scales
        else:
            # ShardedCorpus: gather the (zero-padded) shards and trim
            # (quantized shards carry feature padding; int4 keeps its
            # packed width — dim is in the metadata for the unpack).
            width = (self._device.data.shape[1]
                     if self.storage == "int4" else self.dim)
            data = np.asarray(self._device.data[: self.n, : width])
            scales = self._device.scales
        arrays = {"n": np.int64(self.n), "dim": np.int64(self.dim),
                  "storage": np.array(self.storage)}
        if self.storage == "bf16":
            arrays["data_u16"] = data.view(np.uint16)
        else:
            arrays["data"] = data
        if scales is not None:
            arrays["scales"] = np.asarray(scales[: self.n])
        if self._tombstones is not None:
            arrays["tombstones"] = self._tombstones
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(
        cls,
        path,
        *,
        mesh=None,
        capacity: Optional[int] = None,
        config: Optional[SearchConfig] = None,
    ) -> "Corpus":
        """Rebuild a saved corpus; uploads exactly the storage-native
        bytes (int8 corpora are NOT requantized — codes round-trip)."""
        with np.load(path, allow_pickle=False) as z:
            storage = str(z["storage"])
            if storage == "bf16":
                import ml_dtypes

                data = z["data_u16"].view(ml_dtypes.bfloat16)
            else:
                data = z["data"]
            scales = z["scales"] if "scales" in z else None
            tomb = z["tombstones"] if "tombstones" in z else None
            dim4 = int(z["dim"]) if storage == "int4" else None
        obj = cls(data, mesh=mesh, storage=storage, scales=scales,
                  dim=dim4, capacity=capacity, config=config)
        if tomb is not None and tomb.any():
            obj._tombstones = tomb.astype(bool)
            obj._alive_dev = None
        return obj

    def delete(self, indices: ArrayLike) -> int:
        """Tombstone corpus rows: they never match again (topk only).

        Deletion rides the filtered-search mask, so it is O(1) in corpus
        work — the device corpus and its prepared forms are untouched.
        Returns the total number of tombstoned rows.  ``matmul`` still
        scores deleted rows (it returns the raw panel by contract).
        """
        idx = np.asarray(indices).reshape(-1)
        if idx.size and not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"delete indices must be integers, got dtype {idx.dtype}"
            )
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise ValueError(
                f"delete indices must be in [0, {self.n}); got "
                f"[{idx.min()}, {idx.max()}]"
            )
        if self._tombstones is None:
            self._tombstones = np.zeros(self.n, dtype=bool)
        self._tombstones[idx] = True
        self._alive_dev = None  # invalidate the cached device mask
        return int(self._tombstones.sum())

    @property
    def deleted_count(self) -> int:
        return 0 if self._tombstones is None else int(self._tombstones.sum())

    def _combined_mask(self, mk):
        if self._tombstones is None:
            return mk
        alive = ~self._tombstones
        return alive if mk is None else (mk & alive)

    def _device_mask(self, user_mk):
        """Device bool mask combining tombstones with the per-call user
        mask, or None.  The tombstone-only case (the common serving loop
        after deletes) reuses one cached device array instead of doing an
        O(n) host combine + (n,)-mask upload per query."""
        if self._tombstones is None:
            return None if user_mk is None else _to_jax(
                user_mk, np.dtype(bool))
        if user_mk is None:
            if self._alive_dev is None:
                import jax

                self._alive_dev = jax.block_until_ready(
                    _to_jax(~self._tombstones, np.dtype(bool)))
            return self._alive_dev
        return _to_jax(user_mk & ~self._tombstones, np.dtype(bool))

    def _effective_precision(self) -> str:
        """The search tier this handle runs with.

        bf16 storage always uses the "bf16c" tier and int8/int4 storage
        the "int8c"/"int4c" tiers: the values are
        quantized at rest, so requesting "highest"/"bf16x3" could only
        spend memory, not recover accuracy.
        """
        if self.storage == "bf16":
            return "bf16c"
        if self.storage == "int8":
            return "int8c"
        if self.storage == "int4":
            return "int4c"
        return self.config.precision

    def _dense_device(self):
        """Dense compute-dtype corpus for matmul and the f64 search path
        (cached for quantized storage); (n, dim) exactly (storage padding
        trimmed)."""
        if self.storage == "f32":
            return (self._device if self._device.shape[0] == self.n
                    else self._device[: self.n])
        if self._f32_view is None:
            import jax
            import jax.numpy as jnp

            if self.storage == "int8":
                dense = (
                    self._device[: self.n, : self.dim].astype(jnp.float32)
                    * self._scales[: self.n, None])
            elif self.storage == "int4":
                from ..kernels.fused_topk import dequant_int4

                dense = dequant_int4(self._device[: self.n],
                                     self._scales[: self.n], self.dim)
            else:
                dense = self._device[: self.n].astype(jnp.float32)
            self._f32_view = jax.block_until_ready(dense)
        return self._f32_view

    def _prepared_for(self, metric):
        """Cached (cp, cbp) from kernels.fused_topk.prepare_corpus.

        Quantized storage shares its code buffer as cp; only the (2, rows)
        scale|bias operand is computed.  Large float corpora are prepared
        in row chunks with the output buffers donated through each
        update: one-shot prep transiently holds ~3x the corpus bytes,
        chunked ~2x + one chunk.
        """
        from ..kernels.fused_topk import prepare_corpus

        precision = self._effective_precision()
        # Key on the precision too: the handle's config is mutable
        # (examples do `corpus.config = cfg`).
        key = (metric.value, precision)
        if key in self._prepared:
            return self._prepared[key]

        import functools

        import jax

        if self._quantized and self.mesh is None:
            self._prepared[key] = (
                self._device, self._quant_bias_rows(metric))
            return self._prepared[key]

        def prep(chunk):
            return prepare_corpus(chunk, metric, precision=precision)

        c = self._device  # prepare_corpus upcasts bf16 chunks internally
        raw_bytes = c.shape[0] * c.shape[1] * c.dtype.itemsize
        if raw_bytes <= self.config.prep_chunk_bytes:
            self._prepared[key] = jax.block_until_ready(
                self._mask_capacity_tail(*jax.jit(prep)(c)))
            return self._prepared[key]

        import jax.numpy as jnp

        row_bytes = c.shape[1] * c.dtype.itemsize
        rows_per_chunk = max(1, self.config.prep_chunk_bytes // row_bytes)
        n = c.shape[0]
        probe_cp, probe_cb = jax.eval_shape(
            prep, jax.ShapeDtypeStruct((rows_per_chunk, c.shape[1]),
                                       c.dtype))
        buf_cp = jnp.zeros((n, probe_cp.shape[1]), probe_cp.dtype)
        buf_cb = jnp.zeros((probe_cb.shape[0], n), probe_cb.dtype)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def update(buf_cp, buf_cb, row0, chunk):
            cpc, cbc = prep(chunk)
            buf_cp = jax.lax.dynamic_update_slice(
                buf_cp, cpc, (row0, jnp.int32(0)))
            buf_cb = jax.lax.dynamic_update_slice(
                buf_cb, cbc, (jnp.int32(0), row0))
            return buf_cp, buf_cb

        row0 = 0
        while row0 < n:
            rows = min(rows_per_chunk, n - row0)
            chunk = jax.lax.dynamic_slice_in_dim(c, row0, rows, axis=0)
            buf_cp, buf_cb = update(buf_cp, buf_cb, jnp.int32(row0), chunk)
            row0 += rows
        self._prepared[key] = jax.block_until_ready(
            self._mask_capacity_tail(buf_cp, buf_cb))
        return self._prepared[key]

    def _quant_bias_rows(self, metric):
        """(2, rows) scale|bias for a shared quantized (int8/int4) code
        buffer, computed in row chunks (the transient f32 upcast inside
        the norm is bounded by one chunk)."""
        import functools as _ft

        import jax
        import jax.numpy as jnp

        from ..kernels.fused_topk import (prepare_int4_bias,
                                          prepare_int8_bias)

        bias_fn = (prepare_int4_bias if self.storage == "int4"
                   else prepare_int8_bias)
        rows = self._device.shape[0]
        row_bytes = self._device.shape[1] * 4  # f32 upcast dominates
        per_chunk = max(
            4096, self.config.prep_chunk_bytes // row_bytes // 4096 * 4096
        )
        if rows <= per_chunk:
            fn = jax.jit(_ft.partial(bias_fn, metric=metric))
            return jax.block_until_ready(
                fn(self._device, self._scales, n_valid=jnp.int32(self.n)))

        buf = jnp.zeros((2, rows), jnp.float32)

        @_ft.partial(jax.jit, donate_argnums=(0,))
        def update(buf, codes_c, scales_c, row0, n_valid_local):
            cbc = bias_fn(codes_c, scales_c, metric, n_valid_local)
            return jax.lax.dynamic_update_slice(
                buf, cbc, (jnp.int32(0), row0))

        row0 = 0
        while row0 < rows:
            nr = min(per_chunk, rows - row0)
            codes_c = jax.lax.dynamic_slice_in_dim(
                self._device, row0, nr, axis=0)
            scales_c = jax.lax.dynamic_slice_in_dim(
                self._scales, row0, nr, axis=0)
            buf = update(buf, codes_c, scales_c, jnp.int32(row0),
                         jnp.int32(self.n - row0))
            row0 += nr
        return jax.block_until_ready(buf)

    def _mask_capacity_tail(self, cp, cbp):
        """Reserved-capacity rows ([n, _cap)) are zeros in the raw buffer;
        the prep treats them as real rows, so force their bias to -inf
        (the same mechanism that excludes tile-padding rows).  ``add()``
        later overwrites both the rows and their bias entries in place.
        The bias is the LAST cbp row (int8c carries a scale row above it,
        which must stay finite: 0 * -inf would poison the tail with NaN).

        Condition on the PREP width, not ``_cap``: int8 buffers are
        row-padded to a 4096 multiple even without ``capacity=``, and a
        copy-path prep (exotic tile height) treats those zero rows as
        real — without this they would surface as index >= n with score
        0.0 whenever every true score is negative."""
        if cbp.shape[1] > self.n:
            cbp = cbp.at[-1:, self.n:].set(-np.inf)
        return cp, cbp

    def topk(
        self, queries: ArrayLike, k: int,
        metric: Union[str, Metric] = "cosine",
        *, mask: Optional[ArrayLike] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        metric = Metric.parse(metric)
        q = np.asarray(queries)
        if q.shape[0] == 0:
            return (np.empty((0, 0), np.uint32), np.empty((0, 0), np.float64))
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{q.shape[1] if q.ndim == 2 else q.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        user_mk = _validate_mask(mask, self.n)
        masked = user_mk is not None or self._tombstones is not None
        kk = min(int(k), self.n)
        if kk <= 0:
            # same contract as module-level topk: k=0 -> empty match lists
            return (
                np.empty((q.shape[0], 0), np.uint32),
                np.empty((q.shape[0], 0), np.float64),
            )
        # Half-precision queries (f16 / ml_dtypes bf16) serve on the f32
        # path, and so does every query against a quantized (bf16/int8/
        # int4) corpus: f64 compute on quantized inputs would be theater.
        # Half-precision queries also upload at half the host->device
        # bytes (the only per-call transfer once the corpus is resident)
        # and upcast on device.
        half_q = (q.dtype.itemsize == 2
                  and np.issubdtype(q.dtype, np.floating)
                  or str(q.dtype) == "bfloat16")
        dt = (np.dtype(np.float32) if half_q or self.storage != "f32"
              else compute_dtype(q.dtype, self.dtype))
        if self.mesh is not None:
            from ..parallel.sharded import distributed_topk

            vals, idx = distributed_topk(
                _to_jax(q, dt), self._device, kk, metric, self.mesh,
                self.config, mask=self._combined_mask(user_mk),
            )
        elif dt == np.float64:
            from ..kernels.fused_topk import fused_topk

            dense = self._dense_device()  # (n, dim): padding trimmed
            with annotate(f"pmm.topk.{metric.value}"):
                vals, idx = fused_topk(
                    _to_jax(q, dt), dense.astype(dt), kk, metric,
                    mask=self._combined_mask(user_mk), config=self.config)
        else:
            qj = _to_jax(q, q.dtype) if half_q else _to_jax(q, dt)
            cp, cbp = self._prepared_for(metric)
            run_cfg = self.config.with_updates(
                precision=self._effective_precision())
            key = (kk, metric, run_cfg, masked)
            fn = _cached_fn(self._packed_fns, key, _packed_prepared_fn)
            mkj = self._device_mask(user_mk)
            args = (qj, cp, cbp) + (() if mkj is None else (mkj,))
            with annotate(f"pmm.topk.{metric.value}"):
                packed = np.asarray(fn(*args))
            v, i = _unpack_pair(packed, kk)
            return i.astype(np.uint32), v.astype(np.float64)
        v, i = _fetch_topk(vals, idx, kk)
        return i.astype(np.uint32), v.astype(np.float64)

    def matmul(self, queries: ArrayLike) -> np.ndarray:
        q = np.asarray(queries)
        if q.shape[0] == 0:
            dt = compute_dtype(q.dtype, self.dtype)
            return np.empty((0, self.n), dtype=dt)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{q.shape[1] if q.ndim == 2 else q.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        dt = compute_dtype(q.dtype, self.dtype)
        if self.mesh is not None:
            from ..parallel.sharded import distributed_matmul

            out = distributed_matmul(
                _to_jax(q, dt), self._device, self.mesh, self.config
            )
            return _host_owned(out)
        from ..kernels.matmul import pairwise_matmul

        dense = self._dense_device()  # (n, dim): padding trimmed
        cj = dense if np.dtype(dense.dtype) == dt else dense.astype(dt)
        with annotate("pmm.matmul"):
            out = pairwise_matmul(_to_jax(q, dt), cj)
        return _host_owned(out)
