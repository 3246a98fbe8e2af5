"""Corpus-sharded distributed search (shard_map + XLA collectives).

The answer to the reference's (absent) distributed layer (SURVEY.md §2.3,
§5): the corpus is block-partitioned across the ``corpus`` mesh axis, each
device runs the top-k scan on its shard with global index offsets, and
per-shard k-candidates are merged by a re-select — the exchange is tiny
(k x (idx, score) per shard per query).

Block (contiguous) partitioning is chosen over hash partitioning
deliberately: shard s owns global rows [s*ns, (s+1)*ns), so the gathered
candidate list is ordered by global index and a plain ``lax.top_k`` re-select
preserves the lowest-index-wins tie contract (SURVEY.md §7 hard part #1)
with no extra keying.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ..config import SearchConfig, resolve
from ..ops.metrics import Metric
from ..ops.reference import topk_from_scores


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class ShardedCorpus:
    """Device-resident corpus, block-partitioned over the corpus mesh axis.

    ``data`` is zero-padded to a multiple of the shard count; ``n_true`` is
    the real row count (padding rows are masked out of every search).
    """

    data: "jax.Array"  # noqa: F821  (n_padded, dim), sharded over corpus axis
    n_true: int
    # int8 storage: (n_padded,) f32 per-row dequant scales, sharded with
    # the rows (pad rows get scale 1.0 so they dequantize to exact zero).
    scales: "Optional[jax.Array]" = None  # noqa: F821
    # Original (unpadded) feature width; quantized shared-storage shards
    # carry 128-padded (int8) or nibble-packed (int4) features.
    dim: Optional[int] = None
    # Quantized storage mode for the shards: "int8" or "int4" when
    # ``scales`` is set.
    storage: str = "f32"
    # Built with reserved growth rows (Corpus(capacity=, mesh=)): forces
    # the live-mask search path so the compiled program is independent
    # of the (mutable) live count.
    has_capacity: bool = False
    # Lazily-built per-(metric, precision) prepared forms (pre-scaled and
    # converted per shard) so steady-state distributed queries do zero
    # per-call corpus work — the sharded analog of Corpus._prepared_for.
    _prepared: dict = dataclasses.field(default_factory=dict, repr=False)
    # Cached dense-f32 shards for the matmul path on quantized storage
    # (the sharded analog of Corpus._f32_view): built once, not
    # re-dequantized on every call.
    _f32_view: "Optional[jax.Array]" = dataclasses.field(  # noqa: F821
        default=None, repr=False)
    # Cached live-row mask for heavily padded (int8 shared-storage)
    # layouts — depends only on (shape, n_true), so never rebuilt per call.
    _live_mask: "Optional[jax.Array]" = dataclasses.field(  # noqa: F821
        default=None, repr=False)

    def live_mask(self, mesh, cfg: SearchConfig):
        if self._live_mask is None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            mask = np.arange(self.data.shape[0]) < self.n_true
            self._live_mask = jax.device_put(
                mask, NamedSharding(mesh, P(cfg.mesh_axes[1])))
        return self._live_mask

    @property
    def shape(self):
        return self.data.shape

    def dense_f32(self, mesh, cfg: SearchConfig):
        """Dense value shards (dequantized / upcast at shard granularity,
        cached) for the distributed matmul."""
        if str(self.data.dtype) == "float32":
            return self.data
        if str(self.data.dtype) == "float64":
            # f64 shards serve the exact f64 search/matmul paths AS IS
            # (the both-f32 rule the single-device handle honors) — a
            # downcast here silently truncated distinct rows to equal
            # f32 values while returning f64-typed results
            return self.data
        dim = self.dim or self.data.shape[1]
        if self._f32_view is None:
            import jax
            import jax.numpy as jnp
            from jax.sharding import PartitionSpec as P

            c_axis = cfg.mesh_axes[1]
            if self.scales is not None:
                if self.storage == "int4":
                    from ..kernels.fused_topk import dequant_int4

                    def dequant(c_, s_):
                        return dequant_int4(c_, s_, dim)
                else:
                    def dequant(c_, s_):
                        return (c_[:, :dim].astype(jnp.float32)
                                * s_[:, None])

                mapped = _shard_map(
                    dequant, mesh,
                    in_specs=(P(c_axis, None), P(c_axis)),
                    out_specs=P(c_axis, None),
                )
                view = jax.jit(mapped)(self.data, self.scales)
            else:
                def upcast(c_):
                    return c_.astype(jnp.float32)

                mapped = _shard_map(
                    upcast, mesh,
                    in_specs=(P(c_axis, None),),
                    out_specs=P(c_axis, None),
                )
                view = jax.jit(mapped)(self.data)
            self._f32_view = jax.block_until_ready(view)
        return self._f32_view

    def prepared_for(self, metric: Metric, mesh, cfg: SearchConfig):
        """Cached per-shard (cp, cbp) from kernels.fused_topk.prepare_corpus.

        Quantized shards are their own cp; only the per-shard (2, ns)
        scale|bias rows are computed, each shard masking its rows beyond
        the global live count.  Large float shards are prepared in row
        chunks with donated output buffers (one-shot prep transiently
        holds ~3x the shard bytes, chunked ~2x + one chunk), mirroring
        Corpus._prepared_for.
        """
        from ..kernels.fused_topk import prepare_corpus

        key = (metric.value, cfg.precision)
        if key in self._prepared:
            return self._prepared[key]

        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        c_axis = cfg.mesh_axes[1]
        n_shards = mesh.shape[c_axis]
        ns = self.data.shape[0] // n_shards
        dim = self.data.shape[1]
        itemsize = self.data.dtype.itemsize

        if self.scales is not None:
            from ..kernels.fused_topk import (prepare_int4_bias,
                                              prepare_int8_bias)

            bias_fn = (prepare_int4_bias if self.storage == "int4"
                       else prepare_int8_bias)
            n_true = self.n_true
            # Chunked: the transient f32 code upcast inside the norm stays
            # bounded by one row chunk per shard.
            per = min(ns, max(4096, cfg.prep_chunk_bytes // (dim * 4)
                              // 4096 * 4096))
            buf = jax.device_put(
                jnp.zeros((2, self.data.shape[0]), jnp.float32),
                jax.sharding.NamedSharding(mesh, P(None, c_axis)),
            )

            def make_update(rows):
                # r0 rides as a TRACED operand so all full-size chunks
                # share one compiled program (a fresh closure per chunk
                # would compile a shard_map program per chunk).
                def upd(buf_, r0_, codes_, scales_):
                    off = jax.lax.axis_index(c_axis) * ns
                    r0i = r0_[0]
                    c_ = jax.lax.dynamic_slice_in_dim(codes_, r0i, rows, 0)
                    s_ = jax.lax.dynamic_slice_in_dim(scales_, r0i, rows, 0)
                    cbc = bias_fn(c_, s_, metric, n_true - off - r0i)
                    return jax.lax.dynamic_update_slice(
                        buf_, cbc, (jnp.int32(0), r0i))

                mapped = _shard_map(
                    upd, mesh,
                    in_specs=(P(None, c_axis), P(), P(c_axis, None),
                              P(c_axis)),
                    out_specs=P(None, c_axis),
                )
                return jax.jit(mapped, donate_argnums=(0,))

            fns = {}
            r0 = 0
            while r0 < ns:
                rows = min(per, ns - r0)
                if rows not in fns:
                    fns[rows] = make_update(rows)
                buf = fns[rows](buf, jnp.asarray([r0], jnp.int32),
                                self.data, self.scales)
                r0 += rows
            self._prepared[key] = (self.data, jax.block_until_ready(buf))
            return self._prepared[key]

        def prep(chunk):
            return prepare_corpus(chunk, metric, precision=cfg.precision)

        if ns * dim * itemsize <= cfg.prep_chunk_bytes:
            mapped = _shard_map(
                prep, mesh,
                in_specs=(P(c_axis, None),),
                out_specs=(P(c_axis, None), P(None, c_axis)),
            )
            self._prepared[key] = jax.block_until_ready(
                jax.jit(mapped)(self.data))
            return self._prepared[key]

        # Chunked path: every shard processes its local rows
        # [r0, r0 + rows) in lockstep.
        rows_per_chunk = max(1, cfg.prep_chunk_bytes // (dim * itemsize))
        probe_cp, probe_cb = jax.eval_shape(
            prep, jax.ShapeDtypeStruct((rows_per_chunk, dim),
                                       self.data.dtype))
        buf_cp = jax.device_put(
            jnp.zeros((n_shards * ns, probe_cp.shape[1]), probe_cp.dtype),
            jax.sharding.NamedSharding(mesh, P(c_axis, None)),
        )
        buf_cb = jax.device_put(
            jnp.zeros((probe_cb.shape[0], n_shards * ns), probe_cb.dtype),
            jax.sharding.NamedSharding(mesh, P(None, c_axis)),
        )

        def make_update(rows):
            # Each shard slices ITS local rows [r0, r0 + rows) — a
            # per-shard operation, so it lives inside the shard_map.
            # r0 is a TRACED operand: full-size chunks share one
            # compiled program instead of one per chunk.
            def update_local(buf_cp_, buf_cb_, r0_, data_):
                r0i = r0_[0]
                c_ = jax.lax.dynamic_slice_in_dim(data_, r0i, rows, 0)
                cpc, cbc = prep(c_)
                bp = jax.lax.dynamic_update_slice(
                    buf_cp_, cpc, (r0i, jnp.int32(0)))
                bb = jax.lax.dynamic_update_slice(
                    buf_cb_, cbc, (jnp.int32(0), r0i))
                return bp, bb

            mapped = _shard_map(
                update_local, mesh,
                in_specs=(P(c_axis, None), P(None, c_axis), P(),
                          P(c_axis, None)),
                out_specs=(P(c_axis, None), P(None, c_axis)),
            )
            return jax.jit(mapped, donate_argnums=(0, 1))

        fns = {}
        r0 = 0
        while r0 < ns:
            rows = min(rows_per_chunk, ns - r0)
            if rows not in fns:
                fns[rows] = make_update(rows)
            buf_cp, buf_cb = fns[rows](buf_cp, buf_cb,
                                       jnp.asarray([r0], jnp.int32),
                                       self.data)
            r0 += rows
        self._prepared[key] = jax.block_until_ready((buf_cp, buf_cb))
        return self._prepared[key]


def shard_corpus(c, mesh, config: Optional[SearchConfig] = None,
                 scales=None, storage: str = "int8",
                 dim: Optional[int] = None,
                 capacity: Optional[int] = None) -> ShardedCorpus:
    """Block-partition a corpus (optionally int8 codes + per-row scales)
    over the corpus mesh axis.

    int8 corpora get the shared-storage layout: every shard's height is
    padded to a 4096 multiple and features to a multiple of 128, so the
    per-shard prepared form ALIASES the shard data instead of copying it.  Original rows stay contiguous
    at global positions [0, n) — the standard index mapping is untouched
    — and all padding rows map to global indices >= n, which the merge
    already masks.

    ``capacity`` reserves extra zero rows at the global tail for
    ``Corpus.add`` on mesh: the handle then always searches through the
    live-row mask, so growth within capacity is a scatter into existing
    buffers with zero recompilation.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = resolve(config)
    axis = cfg.mesh_axes[1]
    n_shards = mesh.shape[axis]
    n = c.shape[0]
    cap = n if capacity is None else max(int(capacity), n)
    if scales is not None:
        from ..kernels.fused_topk import feature_geometry

        if storage == "int4":
            # caller already nibble-packed; width is final
            if dim is None:
                raise ValueError(
                    "shard_corpus(storage='int4') requires dim= (the "
                    "packed width is ambiguous)"
                )
            width = c.shape[1]
            orig_dim = dim
        else:
            _, width, _ = feature_geometry(c.shape[1])
            orig_dim = c.shape[1]
        ns = _round_up(-(-cap // n_shards), 4096)
        codes_p = np.zeros((ns * n_shards, width), np.int8)
        codes_p[:n, : c.shape[1]] = np.asarray(c)
        scales_p = np.ones(ns * n_shards, np.float32)
        scales_p[:n] = np.asarray(scales)
        data = jax.device_put(codes_p, NamedSharding(mesh, P(axis, None)))
        sh_scales = jax.device_put(
            scales_p, NamedSharding(mesh, P(axis)))
        return ShardedCorpus(data, n, scales=sh_scales, dim=orig_dim,
                             storage=storage,
                             has_capacity=capacity is not None)
    n_pad = _round_up(cap, n_shards)
    sharding = NamedSharding(mesh, P(axis, None))
    if n_pad != n:
        # pad on HOST: jnp.pad would materialize the whole padded corpus
        # on one device before resharding — a staging copy that can OOM
        # a chip the sharded result fits on comfortably
        ch = np.asarray(c)
        padded = np.zeros((n_pad, ch.shape[1]), ch.dtype)
        padded[:n] = ch
        return ShardedCorpus(jax.device_put(padded, sharding), n,
                             has_capacity=capacity is not None)
    return ShardedCorpus(jax.device_put(c, sharding), n,
                         has_capacity=capacity is not None)


def _shard_map(fn, mesh, in_specs, out_specs):
    import jax

    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _merge_sorted_2key(vals, idx, k: int, hib: bool):
    """Exact top-k of a candidate panel with explicit (score, index) keys.

    Used where candidate order is NOT global-index order (ring merge), so a
    positional tie-break would be wrong: sorts ascending by
    (-score if hib else score, index) and keeps the first k columns.
    """
    import jax

    key = -vals if hib else vals
    key_s, idx_s, vals_s = jax.lax.sort(
        (key, idx, vals), dimension=1, num_keys=2
    )
    del key_s
    return vals_s[:, :k], idx_s[:, :k]


# The shard_map program is expensive to trace AND compile (seconds);
# cache the jitted callable per (mesh, problem signature).  Mesh and the
# frozen SearchConfig are both hashable; jit itself handles shape
# polymorphism beneath each cache entry.  ``prepared`` selects the
# zero-corpus-work path fed by ShardedCorpus.prepared_for.
@lru_cache(maxsize=64)
def _topk_callable(mesh, k, k_local, ns, metric: Metric,
                   cfg: SearchConfig, prepared: bool = False,
                   masked: bool = False, probed=None):
    """``probed=(p_local, tm, tn)`` (prepared path only) adds two operands
    — replicated centroids and the shard's tile-cluster slice — and each
    shard probe-ranks its own corpus tiles before the scan visits only the
    listed ones (distributed IVF: equal per-shard probe budget,
    load-balanced by construction).

    The live row count rides as a TRACED int32 operand (``nl_``), not a
    compile-time constant, so growing a capacity-reserved corpus
    (``Corpus.add`` on mesh) never recompiles the search program."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..kernels.fused_topk import fused_topk, fused_topk_prepared
    from ..ops.cluster import probe_tiles

    d_axis, c_axis = cfg.mesh_axes
    n_shards = mesh.shape[c_axis]
    hib = metric.higher_is_better
    worst = jnp.float32(-np.inf if hib else np.inf)
    shards_data = mesh.shape[d_axis] > 1
    q_spec = P(d_axis, None) if shards_data else P()
    row_spec = d_axis if shards_data else None

    def finish(nl_, vals, idx):
        # Sentinel slots (idx == INT32_MAX when a masked shard had fewer
        # matches than k_local) must not take the offset: the add would
        # overflow int32 and the negative result would win tie sorts and
        # slip past the pad-row check.
        sent = idx == jnp.iinfo(jnp.int32).max
        off = jax.lax.axis_index(c_axis) * ns
        gidx = jnp.where(sent, idx, idx + off)
        vals = jnp.where(sent | (gidx >= nl_), worst, vals)
        return vals, gidx

    if prepared and probed is not None:
        # tn is the LAYOUT's tile height: tile_cluster ids address the
        # corpus at that granularity.
        p_local, tm, tn_probe = probed

        def local_topk(q_, nl_, cp_, cb_, cent_, tc_, *m_):
            tiles = probe_tiles(q_, cent_, tc_, p=p_local, tm=tm,
                                metric_v=metric.value)
            mk = m_[0] if m_ else None
            return finish(nl_, *fused_topk_prepared(
                q_, cp_, cb_, k_local, metric, mask=mk, config=cfg,
                tiles=tiles, tn=tn_probe,
            ))

        corpus_in_specs = (P(c_axis, None), P(None, c_axis), P(None, None),
                           P(c_axis))
    elif prepared:
        def local_topk(q_, nl_, cp_, cb_, *m_):
            mk = m_[0] if m_ else None
            return finish(nl_, *fused_topk_prepared(
                q_, cp_, cb_, k_local, metric, mask=mk, config=cfg
            ))

        corpus_in_specs = (P(c_axis, None), P(None, c_axis))
    else:
        def local_topk(q_, nl_, c_, *m_):
            # f64 search: the dense reference path on each shard.
            mk = m_[0] if m_ else None
            return finish(nl_, *fused_topk(q_, c_.astype(q_.dtype),
                                           k_local, metric, mask=mk,
                                           config=cfg))

        corpus_in_specs = (P(c_axis, None),)
    if masked:
        corpus_in_specs = corpus_in_specs + (P(c_axis),)

    if cfg.merge == "ring":
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

        def ring_chain(acc_v, acc_i):
            buf_v, buf_i = acc_v, acc_i
            for _step in range(n_shards - 1):
                buf_v = jax.lax.ppermute(buf_v, c_axis, perm)
                buf_i = jax.lax.ppermute(buf_i, c_axis, perm)
                cat_v = jnp.concatenate([acc_v, buf_v], axis=1)
                cat_i = jnp.concatenate([acc_i, buf_i], axis=1)
                acc_v, acc_i = _merge_sorted_2key(cat_v, cat_i, k, hib)
            return acc_v, acc_i

        def ring_fn(q_, nl_, *c_args):
            # Pipeline the merge with compute: each query chunk's ring
            # exchange is dataflow-independent of the next chunk's local
            # search, so XLA's scheduler can overlap the hops with the
            # next chunk's search.
            m = q_.shape[0]
            n_chunks = max(1, min(cfg.ring_pipeline, m))
            bounds = [m * i // n_chunks for i in range(n_chunks + 1)]
            outs = [
                ring_chain(*local_topk(q_[bounds[i]:bounds[i + 1]], nl_,
                                       *c_args))
                for i in range(n_chunks)
            ]
            acc_v = jnp.concatenate([o[0] for o in outs], axis=0)
            acc_i = jnp.concatenate([o[1] for o in outs], axis=0)
            return acc_v, acc_i

        mapped = _shard_map(
            ring_fn,
            mesh,
            in_specs=(q_spec, P(), *corpus_in_specs),
            out_specs=(P(row_spec, None), P(row_spec, None)),
        )

        def run(q, n_live, *c_args):
            vals_m, idx_m = mapped(q, jnp.int32(n_live), *c_args)
            return vals_m[:, :k], idx_m[:, :k].astype(jnp.int32)

        return jax.jit(run)

    mapped = _shard_map(
        local_topk,
        mesh,
        in_specs=(q_spec, P(), *corpus_in_specs),
        out_specs=(P(row_spec, c_axis), P(row_spec, c_axis)),
    )

    def run(q, n_live, *c_args):
        vals_g, idx_g = mapped(q, jnp.int32(n_live), *c_args)
        merged_vals, merged_pos = topk_from_scores(vals_g, k, hib)
        merged_idx = jnp.take_along_axis(idx_g, merged_pos, axis=1)
        return merged_vals, merged_idx.astype(jnp.int32)

    return jax.jit(run)


def distributed_topk(
    q,
    corpus: ShardedCorpus,
    k: int,
    metric,
    mesh,
    config: Optional[SearchConfig] = None,
    *,
    mask=None,
    probe=None,
) -> Tuple["jax.Array", "jax.Array"]:  # noqa: F821
    """Top-k over a sharded corpus.

    ``probe=(centroids, tile_cluster_sharded, p_local)`` opts into probed
    (clustered) search: each shard ranks its OWN corpus tiles against the
    replicated centroids and visits only its best ``p_local`` (equal
    per-shard budget — distributed IVF).  Requires the corpus rows to be
    laid out cluster-contiguous (see api.clustered); indices come back in
    the sharded (permuted) space, the caller owns the map-back.

    Phase 1 (shard_map): per-shard top-k scan with global index offsets,
    padding rows masked to worst-score.  Phase 2 merge, per
    ``config.merge``:

    - ``"allgather"`` (default): gather the (m, S*k_local) candidate panels
      (an XLA all-gather) and re-select locally.  Candidate
      order is shard order = global-index order, so lax.top_k's positional
      tie-break preserves lowest-index-wins.
    - ``"ring"``: S-1 ``ppermute`` steps around the corpus-axis ring, each
      device merging the visiting candidate set into its running k-best —
      the ring-attention-shaped variant (SURVEY.md §5 long-context) whose
      per-step exchange is k x (idx, score) and can overlap the next tile's
      compute.  Ties are broken by explicit (score, index) sort keys since
      visit order is not index order.

    Returns (scores, indices) like the single-device path.
    """
    import jax.numpy as jnp

    cfg = resolve(config)
    metric = Metric.parse(metric)
    quant = corpus.scales is not None
    if quant:
        cfg = cfg.with_updates(
            precision="int4c" if corpus.storage == "int4" else "int8c")
    elif str(corpus.data.dtype) == "bfloat16":
        cfg = cfg.with_updates(precision="bf16c")
    # Quantized and bf16 shards are searched in f32 whatever the query
    # width (the values are quantized at rest); f64 shards and f64
    # queries against f32 shards take the f64 reference path.
    if quant or str(corpus.data.dtype) == "bfloat16":
        q = q.astype(jnp.float32)
    use_prepared = (str(q.dtype) == "float32"
                    and str(corpus.data.dtype) != "float64")
    c_axis = cfg.mesh_axes[1]
    n_shards = mesh.shape[c_axis]
    ns = corpus.shape[0] // n_shards
    n_true = corpus.n_true
    k = min(k, n_true)
    # Global zero-pad rows (corpus padded to a multiple of the shard
    # count) take part in the shards' LOCAL selection before they are
    # masked to worst score, so they could evict real candidates.  With
    # the standard layout (pad < n_shards rows, all in the last shard)
    # widening the local k by the pad count guarantees every true top-k
    # member survives the local round.  The quantized layout pads every
    # shard to a 4096-row multiple, so it synthesizes an explicit
    # live-row mask instead (pad rows then score -inf by select and
    # cannot evict anything).
    pad_rows = corpus.shape[0] - n_true
    # Capacity-reserved corpora always take the mask path: k_local then
    # never depends on the (mutable) live count, so Corpus.add reuses
    # the compiled program.
    synth_mask = pad_rows >= n_shards or corpus.has_capacity
    if synth_mask:
        k_local = min(k, ns)
    else:
        k_local = min(k + pad_rows, ns)

    m_args = ()
    masked = mask is not None or synth_mask
    if mask is not None:
        from ..kernels.fused_topk import pad_mask_row

        # pad_mask_row pads the tail with False, so a user mask already
        # excludes every padding row — no live-row combine needed.
        m_args = (pad_mask_row(mask, corpus.shape[0]),)
    elif synth_mask:
        # Cached on the corpus: depends only on (shape, n_true).
        m_args = (corpus.live_mask(mesh, cfg),)
    if not use_prepared:
        fn = _topk_callable(mesh, k, k_local, ns, metric, cfg,
                            masked=masked)
        return fn(q, n_true, corpus.dense_f32(mesh, cfg), *m_args)
    cp, cbp = corpus.prepared_for(metric, mesh, cfg)
    if probe is not None:
        from ..kernels.fused_topk import query_block_rows

        cent, tc, p_local, tn_lay = probe
        d_shards = mesh.shape[cfg.mesh_axes[0]]
        m_local = q.shape[0] // d_shards if d_shards > 1 else q.shape[0]
        tm = query_block_rows(max(1, m_local), cfg)
        fn = _topk_callable(mesh, k, k_local, ns, metric, cfg,
                            prepared=True, masked=masked,
                            probed=(int(p_local), tm, int(tn_lay)))
        return fn(q, n_true, cp, cbp, cent, tc, *m_args)
    fn = _topk_callable(mesh, k, k_local, ns, metric, cfg,
                        prepared=True, masked=masked)
    return fn(q, n_true, cp, cbp, *m_args)


@lru_cache(maxsize=64)
def _matmul_callable(mesh, n_true, cfg: SearchConfig):
    import jax
    from jax.sharding import PartitionSpec as P

    from ..kernels.matmul import pairwise_matmul

    d_axis, c_axis = cfg.mesh_axes
    shards_data = mesh.shape[d_axis] > 1

    def local_fn(q_, c_):
        if c_.dtype != q_.dtype:
            # f64-query contract on an f32 view: upcast per shard.
            c_ = c_.astype(q_.dtype)
        return pairwise_matmul(q_, c_)

    q_spec = P(d_axis, None) if shards_data else P()
    mapped = _shard_map(
        local_fn,
        mesh,
        in_specs=(q_spec, P(c_axis, None)),
        out_specs=P(d_axis if shards_data else None, c_axis),
    )

    return jax.jit(lambda q, data: mapped(q, data)[:, :n_true])


def distributed_matmul(
    q,
    corpus: ShardedCorpus,
    mesh,
    config: Optional[SearchConfig] = None,
):
    """Dense Q . C^T over a sharded corpus: per-shard panels concatenated
    along the corpus axis (the output IS (m, n), so it is materialized —
    this op exists for parity with the reference's raw matmul)."""
    cfg = resolve(config)
    fn = _matmul_callable(mesh, corpus.n_true, cfg)
    return fn(q, corpus.dense_f32(mesh, cfg))
