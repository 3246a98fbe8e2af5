"""ClusteredCorpus: device-resident clustered corpus for probed search.

The scaling story past the dense scan: big-corpus serving is HBM-
bandwidth-bound (every query batch streams all N*dim corpus bytes), so
the remaining lever is reading fewer bytes.  Quantized storage
(``Corpus(storage=...)``) shrinks the bytes; this handle skips most of
them — IVF-style: rows are k-means clustered at ingestion and laid out
cluster-contiguous in whole corpus tiles, and each query block visits
only the ``probe=`` fraction of tiles ranked best by a tiny centroid
matmul (kernels/fused_topk.py gathers just the listed tiles; unvisited
tiles are never read).

Search is EXACT over the visited rows; recall vs an exhaustive scan is
controlled by ``probe`` and the clusterability of the data.
``probe=None`` (default) scans everything — identical results to
``Corpus``, same scan, and the clustered layout costs nothing but the
cluster-tail padding.

The reference has no analog (single-process exhaustive scan only,
reference src/metrics.rs:40-255); this is new construction in the same
spirit as the resident ``Corpus`` handle (SURVEY.md §5).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..config import SearchConfig, resolve
from ..ops.metrics import Metric
from ..ops.cluster import (
    ClusterLayout,
    assign_rows,
    assign_rows_native,
    cluster_layout,
    kmeans,
    make_assigner,
    permute_rows,
    probe_tiles,
    resolve_probe,
)
from ..utils.profiling import annotate
from .search import (
    ArrayLike,
    _cached_fn,
    _pack_pair,
    _to_jax,
    _unpack_pair,
    _validate_mask,
    _quantize_rows_int4_np,
    _quantize_rows_np,
    _unpack_int4_np,
    compute_dtype,
)

def _probed_fn(kk: int, metric: Metric, cfg: SearchConfig, tn: int,
               p: Optional[int], tm: int, masked: bool):
    """One jitted dispatch: centroid probe -> scan over the listed tiles ->
    permuted-position -> original-id map-back -> packed result.
    ``p=None`` compiles the exhaustive dense-scan variant (no probe
    stage; the slack rows are already -inf-biased in the prep)."""
    import jax
    import jax.numpy as jnp

    from ..kernels.fused_topk import fused_topk_prepared

    big = jnp.int32(np.iinfo(np.int32).max)

    @jax.jit
    def run(qj, cp, cbp, cent, tile_cluster, perm, *m):
        tiles = None
        if p is not None:
            tiles = probe_tiles(qj.astype(jnp.float32), cent, tile_cluster,
                                p=p, tm=tm, metric_v=metric.value)
        vals, idx = fused_topk_prepared(
            qj, cp, cbp, kk, metric, tn=tn, config=cfg, tiles=tiles,
            mask=m[0] if m else None,
        )
        safe = jnp.clip(idx, 0, perm.shape[0] - 1)
        gidx = jnp.take(perm, safe)
        # Sentinel-preserving: unfilled carry slots arrive as int32-max and
        # must not round-trip through the permutation (slack rows can never
        # be selected — their bias is -inf — but an unfilled slot's index
        # is the sentinel itself).
        gidx = jnp.where((idx == big) | (gidx < 0), big, gidx)
        return _pack_pair(vals, gidx)

    return run


def _scatter_fn(_tag, ext: int, _no_scales: bool):
    """Row scatter for ClusteredCorpus.add: optionally grow by ``ext``
    padded rows, then write the new rows (and scales) at their permuted
    positions.  Cached per (ext, has-scales) — jit handles shape retraces."""
    import functools

    import jax
    import jax.numpy as jnp

    # Donate the corpus buffers: without donation XLA allocates a full
    # second copy per add/update — a 2x transient that would OOM a
    # corpus sized to HBM (the int4 capacity tier's whole point).
    donate = (0,) if _no_scales else (0, 3)

    @functools.partial(jax.jit, donate_argnums=donate)
    def scatter(base, pos_d, vals_d, *s):
        if ext:
            base = jnp.pad(base, ((0, ext), (0, 0)))
        base = base.at[pos_d].set(vals_d.astype(base.dtype))
        if s:
            sc = (jnp.pad(s[0], (0, ext), constant_values=1.0)
                  if ext else s[0])
            return base, sc.at[pos_d].set(s[1])
        return (base,)

    return scatter


class ClusteredCorpus:
    """K-means clustered, device-resident corpus for probed top-k search.

    ``clusters`` defaults to ~one cluster per 4 corpus tiles (cluster-tail
    padding then costs ~n/8 extra rows).  ``storage`` composes exactly as
    on ``Corpus``: "bf16" (half HBM), "int8" (quarter), "int4" (eighth).

    ``topk(..., probe=0.05)`` visits the best ~5% of corpus tiles per
    query block; ``probe=None`` is an exhaustive (exact) scan.  Probed
    results may contain fewer than k real matches for adversarial
    probes/masks — unfilled slots carry the same sentinels as filtered
    search (index int32-max, score -inf similarity / +inf distance).
    """

    def __init__(
        self,
        embeddings: ArrayLike,
        *,
        clusters: Optional[int] = None,
        storage: str = "f32",
        mesh=None,
        config: Optional[SearchConfig] = None,
        seed: int = 0,
        kmeans_iters: int = 8,
        sample_rows: int = 131072,
        reserve_tiles: int = 0,
    ):
        import jax
        import jax.numpy as jnp

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
        if not np.issubdtype(c.dtype, np.floating):
            raise ValueError(
                "ClusteredCorpus requires float embeddings (clustering "
                "needs the values; pre-quantized codes belong on Corpus)"
            )

        self.config = cfg
        self.storage = storage
        self.mesh = mesh
        self.n, self.dim = c.shape
        self.dtype = np.dtype(np.float32)  # quantized-or-f32 search path
        self._tn = cfg.block_n

        if clusters is None:
            clusters = self._default_clusters(self.n)
        elif int(clusters) < 1:
            raise ValueError(f"clusters must be >= 1, got {clusters}")

        # --- cluster (sampled k-means, then full chunked assignment) ----
        cf = np.ascontiguousarray(c, dtype=np.float32)
        cent = self._fit_sampled(lambda ids: cf[ids], np.arange(self.n),
                                 int(min(clusters, self.n)),
                                 sample_rows, kmeans_iters, seed)
        self.centroids = cent  # (clusters, dim) f32, device
        self.clusters = int(cent.shape[0])  # kmeans clamps to sample size
        codes = scales = None
        if storage in ("int8", "int4"):
            # Quantize BEFORE assignment so the chunked assignment
            # uploads the codes (needed anyway), not f32 chunks —
            # host->device traffic is what ingestion waits on at
            # corpus scale (10M x 768: 30 GB of f32 assignment
            # chunks vs 7.7 GB of codes).  Assignment on the
            # dequantized rows places each row where its SERVED
            # value lives — if anything a closer fit than the exact
            # f32 row.
            if storage == "int8":
                codes, scales = _quantize_rows_np(cf)
            else:
                from ..kernels.fused_topk import feature_geometry

                ck, dpp, _ = feature_geometry(self.dim)
                codes, scales = _quantize_rows_int4_np(cf, ck, dpp)
            assign = assign_rows_native(codes, scales, cent, storage,
                                        self.dim)
        else:
            assign = assign_rows(cf, cent)
        self.layout: ClusterLayout = cluster_layout(
            assign, self.clusters, self._tn)
        # Dead-tile reserve for in-place growth: ``reserve_tiles`` empty
        # (cluster id -1) tiles are appended to the layout; when a
        # cluster's slack fills, ``_place`` CLAIMS one instead of growing
        # the padded height — so an add within reserve is an O(rows)
        # scatter (no reinstall on mesh, no reallocation single-device).
        self._reserve_tiles = int(reserve_tiles)
        if self._reserve_tiles < 0:
            raise ValueError(
                f"reserve_tiles must be >= 0, got {reserve_tiles}")
        if mesh is None:
            self._extend_dead_tiles(self._reserve_tiles)

        if mesh is not None:
            self._align_layout_for_mesh()
            self._install_mesh_base(cf, codes=codes, scales=scales)
        else:
            # --- permuted device base in storage-native form ------------
            perm = self.layout.perm
            self._perm_dev = _to_jax(perm, np.dtype(np.int32))
            self._tile_cluster_dev = _to_jax(self.layout.tile_cluster,
                                             np.dtype(np.int32))
            self._scales = None
            if storage in ("int8", "int4"):
                # Permute the codes on host (quantized above, before
                # assignment), then upload only the final permuted
                # buffer: a device-side permute holds source +
                # gathered copies simultaneously (2x the code bytes
                # at ingestion).
                safe = np.clip(perm, 0, self.n - 1)
                codes_p = codes[safe]
                codes_p[perm < 0] = 0
                scales_p = np.where(perm >= 0, scales[safe],
                                    1.0).astype(np.float32)
                self._base = _to_jax(codes_p, np.dtype(np.int8))
                self._scales = _to_jax(scales_p, np.dtype(np.float32))
            else:
                base = permute_rows(_to_jax(cf, np.dtype(np.float32)),
                                    self._perm_dev)
                if storage == "bf16":
                    base = base.astype(jnp.bfloat16)
                self._base = jax.block_until_ready(base)
            self._live_dev = self._perm_dev >= 0

        self._prepared = {}   # (metric, precision) -> (cp, cbp)
        self._packed_fns = {}
        self._tombstones: Optional[np.ndarray] = None
        self._drift_rows = 0

    @property
    def drift(self) -> float:
        """Fraction of rows added or updated since the last centroid fit
        (construction, ``rebuild()``, or a saved fit via ``load``) over
        the current row count — a cheap proxy for probe-recall decay,
        since those rows were placed against stale centroids.  Exhaustive
        search never degrades; when this grows large, measure probed
        recall (``probe=`` vs exhaustive) and ``rebuild()``."""
        return self._drift_rows / max(1, self.n)

    def _default_clusters(self, n: int) -> int:
        """Constructor default: about four corpus tiles per cluster."""
        return max(1, -(-n // (4 * self._tn)))

    def _extend_dead_tiles(self, r_tiles: int) -> None:
        """Append ``r_tiles`` DEAD tiles (cluster -1, all rows slack) to
        the layout — the claimable in-place growth reserve (single-device;
        the mesh path folds the reserve into its alignment padding)."""
        if r_tiles <= 0:
            return
        lay = self.layout
        tn = self._tn
        perm = np.concatenate(
            [lay.perm, np.full(r_tiles * tn, -1, np.int32)])
        tcl = np.concatenate(
            [lay.tile_cluster, np.full(r_tiles, -1, np.int32)])
        self.layout = ClusterLayout(perm, lay.row_pos, tcl, lay.counts, tn)

    def _fit_sampled(self, get_rows, ids: np.ndarray, clusters: int,
                     sample_rows: int, kmeans_iters: int, seed: int):
        """Sampled k-means fit shared by the constructor and rebuild():
        fit on at most ``sample_rows`` of ``ids`` (f32 values fetched via
        ``get_rows``).  Returns the device centroid array; callers take
        the actual cluster count from its shape — ``kmeans`` clamps to
        the sample size, so the requested count is an upper bound."""
        import jax

        rng = np.random.default_rng(seed)
        sample_ids = (rng.choice(ids, sample_rows, replace=False)
                      if ids.size > sample_rows else ids)
        cent, _ = kmeans(get_rows(sample_ids), clusters,
                         iters=kmeans_iters, seed=seed)
        return jax.block_until_ready(cent)

    def _gather_native_host(self):
        """Host copy of the storage-native payload + scales in the
        CURRENT permuted layout.  Mesh shards are gathered; int8 shards
        carry feature padding to a multiple of 128, trimmed here to the
        code width so every consumer (save files, rebuild) is
        mesh-agnostic — the install path re-derives the padding."""
        if self.mesh is None:
            base = np.asarray(self._base)
            scales = self._scales
        else:
            base = np.asarray(self._sharded.data)
            if self.storage == "int8":
                base = base[:, : self.dim]
            scales = self._sharded.scales
        return base, (None if scales is None
                      else np.asarray(scales, np.float32))

    def _install_payload(self, base: np.ndarray,
                         scales: "Optional[np.ndarray]"):
        """Install a PERMUTED host payload matching ``self.layout`` (on
        the mesh or the single device) and drop every layout-derived
        cache — shared by load() and rebuild()."""
        import jax

        self._prepared = {}
        self._packed_fns = {}
        self._dense = None
        self._perm_mask_dev = None
        if self.mesh is not None:
            g = self._align_layout_for_mesh()
            if g is not None:
                # re-order payload rows to the aligned+striped layout
                # (index len(base) selects the appended zero row)
                zero = np.zeros((1, base.shape[1]), base.dtype)
                base = np.concatenate(
                    [np.ascontiguousarray(base), zero])[g]
                if scales is not None:
                    scales = np.concatenate(
                        [scales, np.ones(1, np.float32)])[g]
            self._install_mesh_payload(np.ascontiguousarray(base),
                                       scales)
        else:
            perm = self.layout.perm
            self._perm_dev = _to_jax(perm, np.dtype(np.int32))
            self._tile_cluster_dev = _to_jax(
                self.layout.tile_cluster, np.dtype(np.int32))
            self._base = jax.block_until_ready(
                _to_jax(base, base.dtype))
            self._scales = (None if scales is None else
                            jax.block_until_ready(
                                _to_jax(scales,
                                        np.dtype(np.float32))))
            self._live_dev = self._perm_dev >= 0

    # -- mesh construction -------------------------------------------------
    def _align_layout_for_mesh(self):
        """Make the layout mesh-ready: pad with DEAD tiles (cluster id
        -1) so every shard owns the same whole number of tiles (shard
        boundaries never split a tile), then STRIPE tiles round-robin
        across shards — consecutive tiles of a cluster land on
        consecutive shards.  The probe budget is per shard, so without
        striping a cluster-contiguous layout concentrates any one
        query's relevant tiles on one shard, capping probed recall at
        that shard's budget; striped, every shard holds a slice of every
        cluster and equal budgets approximate the global tile ranking.

        Returns the row-level gather (new padded position -> old padded
        position, dead rows = old height) for callers holding a payload
        in the PRE-align order, or None when the transform is identity.
        """
        lay = self.layout
        tn = self._tn
        n_shards = self.mesh.shape[self.config.mesh_axes[1]]
        T = lay.n_tiles
        old_rows = lay.perm.shape[0]
        # canonicalize first — UNDO any existing stripe.  Striping on top
        # of a stripe composes to a map that re-concentrates a cluster's
        # tiles on one shard (e.g. lt % n_shards == 0 sends runs of
        # n_shards consecutive canonical tiles to a single shard), which
        # is exactly the recall collapse striping exists to prevent.
        src_tile = np.arange(T, dtype=np.int64)  # canonical tile -> current
        if self._striped_for and self._stripe_lt:
            s0, lt0 = self._striped_for, self._stripe_lt
            t0 = s0 * lt0
            if t0 <= T:
                t = np.arange(t0, dtype=np.int64)
                src_tile[:t0] = (t % s0) * lt0 + t // s0
        # drop dead tiles from the canonical order and re-derive the pad
        # below — carrying them forward verbatim would leak up to
        # n_shards-1 alignment tiles per add-overflow cycle, growing
        # payloads and probe work unboundedly.  (_place CAN refill dead
        # tiles — that is the in-place growth reserve — so the reserve is
        # re-provisioned explicitly in lt, not by keeping stale ones.)
        live_t = src_tile[lay.tile_cluster[src_tile] != -1]
        if live_t.size:
            src_tile = live_t
        tc = src_tile.size
        # alignment + growth reserve: at least reserve_tiles dead tiles
        # survive every (re)install, all claimable by _place
        lt = max(1, -(-(tc + self._reserve_tiles) // n_shards))
        total = lt * n_shards
        self._lt = lt
        if T == total and (n_shards == 1
                           or (self._striped_for == n_shards
                               and self._stripe_lt == lt)):
            # already aligned and striped for this geometry: applying the
            # stripe again would scramble a saved layout, breaking
            # save/load probed-result identity
            return None
        self._striped_for = n_shards
        self._stripe_lt = lt
        # stripe: new position j (shard j//lt, slot j%lt) takes canonical
        # tile (j%lt)*n_shards + j//lt — a bijection spreading each
        # cluster's run of tiles across the shards; positions past the
        # canonical live-tile count are dead padding
        j = np.arange(total, dtype=np.int64)
        ct = (j % lt) * n_shards + j // lt
        old_tile = np.where(ct >= tc, T, src_tile[np.minimum(ct, tc - 1)])
        gather = np.minimum(
            (old_tile[:, None] * tn
             + np.arange(tn, dtype=np.int64)).reshape(-1), old_rows)
        perm = np.concatenate(
            [lay.perm, np.full(1, -1, np.int32)])[gather]
        tcl = np.concatenate(
            [lay.tile_cluster, np.full(1, -1, np.int32)])[
                np.minimum(old_tile, T)]
        row_pos = lay.row_pos.copy()
        live = perm >= 0
        row_pos[perm[live]] = np.flatnonzero(live).astype(np.int32)
        self.layout = ClusterLayout(perm, row_pos, tcl, lay.counts, tn)
        return gather

    def _install_mesh_base(self, cf: np.ndarray, codes=None, scales=None):
        """Host-permute into the clustered layout, storage-native
        (quantization runs on host, so the upload moves quantized
        bytes), then install.  ``codes``/``scales`` reuse a quantization
        already done for assignment (constructor path)."""
        perm = self.layout.perm
        live = perm >= 0
        src = perm[live]
        n_padded = perm.shape[0]
        scales_np = None
        if self.storage in ("int8", "int4"):
            from ..kernels.fused_topk import feature_geometry

            ck, dpp, _ = feature_geometry(self.dim)
            if codes is None:
                if self.storage == "int8":
                    codes, scales = _quantize_rows_np(cf)
                else:
                    codes, scales = _quantize_rows_int4_np(cf, ck, dpp)
            base = np.zeros((n_padded, codes.shape[1]), np.int8)
            base[live] = codes[src]
            scales_np = np.ones(n_padded, np.float32)
            scales_np[live] = scales[src]
        else:
            base = np.zeros((n_padded, self.dim), np.float32)
            base[live] = cf[src]
            if self.storage == "bf16":
                import ml_dtypes

                base = base.astype(ml_dtypes.bfloat16)
        self._install_mesh_payload(base, scales_np)

    def _install_mesh_payload(self, base: np.ndarray,
                              scales_np: "Optional[np.ndarray]"):
        """Shard a PERMUTED host payload straight to the mesh (device_put
        with a NamedSharding — the full corpus is never resident on one
        chip).  Pads rows when the layout was re-aligned for a bigger
        mesh than the payload was built for, and features to a multiple
        of 128 on the int8 path (where the shard data IS the prepared
        cp)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.sharded import ShardedCorpus

        c_axis = self.config.mesh_axes[1]
        n_padded = self.layout.perm.shape[0]
        quant = self.storage in ("int8", "int4")
        width = base.shape[1]
        if self.storage == "int8":
            from ..kernels.fused_topk import feature_geometry

            _, width, _ = feature_geometry(self.dim)
        if base.shape[0] < n_padded or base.shape[1] < width:
            grown = np.zeros((n_padded, width), base.dtype)
            grown[: base.shape[0], : base.shape[1]] = base
            base = grown
        if scales_np is not None and scales_np.shape[0] < n_padded:
            scales_np = np.concatenate([
                scales_np,
                np.ones(n_padded - scales_np.shape[0], np.float32)])
        data = jax.device_put(base, NamedSharding(self.mesh,
                                                  P(c_axis, None)))
        sh_scales = None
        if scales_np is not None:
            sh_scales = jax.device_put(
                scales_np, NamedSharding(self.mesh, P(c_axis)))
        self._sharded = ShardedCorpus(
            data, n_padded, scales=sh_scales,
            dim=self.dim if quant else None,
            storage=self.storage if quant else "f32")
        self._tc_sharded = jax.device_put(
            self.layout.tile_cluster.astype(np.int32),
            NamedSharding(self.mesh, P(c_axis)))
        self._cent_repl = jax.device_put(
            np.asarray(self.centroids, np.float32),
            NamedSharding(self.mesh, P(None, None)))
        self._mesh_mask_dev = None

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        sh = ("" if self.mesh is None else
              f", shards={self.mesh.shape[self.config.mesh_axes[1]]}")
        return (
            f"ClusteredCorpus(n={self.n}, dim={self.dim}, "
            f"clusters={self.clusters}, tiles={self.layout.n_tiles}, "
            f"storage={self.storage!r}{sh})"
        )

    @property
    def n_tiles(self) -> int:
        return self.layout.n_tiles

    def _effective_precision(self) -> str:
        return {"bf16": "bf16c", "int8": "int8c", "int4": "int4c"}.get(
            self.storage, self.config.precision)

    def _prepared_for(self, metric: Metric):
        """(cp, cbp) for this metric with slack rows dead (-inf bias)."""
        import jax
        import jax.numpy as jnp

        from ..kernels.fused_topk import prepare_corpus

        precision = self._effective_precision()
        key = (metric.value, precision)
        if key in self._prepared:
            return self._prepared[key]

        if precision in ("int8c", "int4c"):
            # Shared storage: the permuted code buffer IS the prepared
            # cp (int8/int4 prep never changes the codes), so only the
            # (2, rows) scale|bias operand is computed — a jitted
            # pass-through of the codes would COPY them, doubling the
            # resident bytes.  Interior cluster-tail slack is killed by
            # the live mask (n_valid=rows: the suffix rule cannot see it).
            from ..kernels.fused_topk import (prepare_int4_bias,
                                              prepare_int8_bias)

            bias_fn = (prepare_int4_bias if precision == "int4c"
                       else prepare_int8_bias)

            def prep_bias(base, live, scales):
                cbp = bias_fn(base, scales, metric, base.shape[0])
                bias = jnp.where(live, cbp[-1], -np.inf)[None, :]
                return jnp.concatenate([cbp[:-1], bias], axis=0)

            cbp = jax.block_until_ready(jax.jit(prep_bias)(
                self._base, self._live_dev, self._scales))
            self._prepared[key] = (self._base, cbp)
            return self._prepared[key]

        def prep(base, live):
            cp, cbp = prepare_corpus(base, metric, precision=precision)
            # Cluster-tail slack rows are interior (not a suffix), so the
            # prep's own tail masking does not cover them: kill them in
            # the (last) bias row.  Any finite value elsewhere is fine —
            # slack rows are zero, their dot products are exactly 0.
            bias = jnp.where(live, cbp[-1], -np.inf)[None, :]
            return cp, jnp.concatenate([cbp[:-1], bias], axis=0)

        self._prepared[key] = jax.block_until_ready(
            jax.jit(prep)(self._base, self._live_dev))
        return self._prepared[key]

    def _mesh_mask(self, user_mk):
        """(n_padded,) sharded device bool in permuted space for the
        distributed path: live rows ∧ ~tombstones ∧ user mask.  Slack and
        dead-tile rows are always False — on the mesh the prepared bias
        cannot see interior slack, so the mask operand is what kills it.
        The user-mask-free case (the common serving loop) caches one
        sharded device array."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        if user_mk is None and self._mesh_mask_dev is not None:
            return self._mesh_mask_dev
        perm = self.layout.perm
        live = perm >= 0
        if user_mk is None and self._tombstones is None:
            keep = live
        else:
            combined = (np.ones(self.n, bool) if user_mk is None
                        else user_mk.astype(bool))
            if self._tombstones is not None:
                combined = combined & ~self._tombstones
            keep = np.zeros(perm.shape[0], bool)
            keep[live] = combined[perm[live]]
        dev = jax.device_put(keep, NamedSharding(
            self.mesh, P(self.config.mesh_axes[1])))
        if user_mk is None:
            self._mesh_mask_dev = jax.block_until_ready(dev)
        return dev

    def _mesh_topk(self, q: np.ndarray, kk: int, metric: Metric,
                   probe, user_mk) -> Tuple[np.ndarray, np.ndarray]:
        """Distributed probed/exhaustive top-k: per-shard probe budget
        (``probe`` resolves against each shard's tile count), merge in
        permuted space, then one host map-back to original row ids."""
        from ..parallel.sharded import distributed_topk
        from .search import _fetch_topk

        p_local, exhaustive = resolve_probe(probe, self._lt)
        pr = (None if exhaustive else
              (self._cent_repl, self._tc_sharded, int(p_local),
               self._tn))
        qj = _to_jax(np.ascontiguousarray(q, np.float32),
                     np.dtype(np.float32))
        mk = self._mesh_mask(user_mk)
        with annotate(f"pmm.clustered.topk.{metric.value}"):
            vals, idx = distributed_topk(
                qj, self._sharded, kk, metric, self.mesh, self.config,
                mask=mk, probe=pr)
            v, i = _fetch_topk(vals, idx, kk)
        big = np.iinfo(np.int32).max
        perm = self.layout.perm
        safe = np.clip(i, 0, perm.shape[0] - 1).astype(np.int64)
        g = perm[safe]
        g = np.where((i == big) | (g < 0), big, g)
        return g.astype(np.uint32), v.astype(np.float64)

    # -- mutation ---------------------------------------------------------
    def add(self, rows: ArrayLike) -> int:
        """Append rows; returns the new row count (ids ``n..n+r-1``,
        matching ``Corpus.add``).

        Each new row joins its nearest centroid's cluster: it first fills
        that cluster's tile-tail slack positions; overflow appends whole
        new tiles for the cluster at the end of the permuted layout (tile
        ids only ever grow, so saved probed results stay meaningful).
        Centroids are NOT refit — recall after heavy drift is the
        caller's concern (``drift`` is the signal, ``rebuild()`` the
        recovery).  Prepared forms rebuild lazily on the next query (one
        pass over the corpus); the probe program retraces only when the
        layout grew.

        On mesh handles this is a REINSTALL-grade operation: the layout
        must grow and stay tile-aligned per shard, so the payload is
        gathered to host, the new rows placed, and the result re-sharded
        (storage-native throughout — quantized corpora are never
        requantized).  Batch mesh adds accordingly; per-row calls pay a
        full corpus round trip each.
        """
        import jax

        r = np.asarray(rows)
        if r.ndim != 2 or r.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{r.shape[1] if r.ndim == 2 else r.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        if not np.issubdtype(r.dtype, np.floating):
            raise ValueError("ClusteredCorpus requires float embeddings")
        m = r.shape[0]
        if m == 0:
            return self.n
        cf = np.ascontiguousarray(r, dtype=np.float32)
        assign = assign_rows(cf, self.centroids)
        ids = np.arange(self.n, self.n + m, dtype=np.int64)
        if self.mesh is not None:
            n_old_padded = self.layout.perm.shape[0]
            old_tc = self.layout.tile_cluster
            pos = self._place(ids, assign)
            if self.layout.perm.shape[0] == n_old_padded:
                # every row fit existing slack or a claimed reserve tile:
                # the padded height is unchanged, so this is the same
                # in-place donated per-shard scatter mesh update uses —
                # no gather, no re-shard, no recompile
                from .search import _scatter_rows_sharded

                _scatter_rows_sharded(self._sharded, self.storage,
                                      self.dim, cf, pos)
                self._mesh_mask_dev = None   # the slack rows went live
                self._perm_mask_dev = None
                new_tc = self.layout.tile_cluster
                if not np.array_equal(old_tc, new_tc):
                    # a reserve tile was claimed: refresh the probe's
                    # sharded tile->cluster map — O(n_tiles) int32, the
                    # only non-row byte traffic of an in-reserve add
                    from jax.sharding import (NamedSharding,
                                              PartitionSpec as P)

                    self._tc_sharded = jax.device_put(
                        new_tc.astype(np.int32),
                        NamedSharding(self.mesh,
                                      P(self.config.mesh_axes[1])))
            else:
                # tiles appended: splice on host and re-shard (align will
                # unstripe to canonical order, then re-stripe so the new
                # tiles spread across shards too)
                base, scales = self._gather_native_host()
                vals, vscales = self._quantize_native(cf)
                n_new = self.layout.perm.shape[0]
                new_base = np.zeros((n_new, base.shape[1]), base.dtype)
                new_base[:n_old_padded] = base
                new_base[pos] = vals
                new_scales = None
                if scales is not None:
                    new_scales = np.ones(n_new, np.float32)
                    new_scales[:n_old_padded] = scales
                    new_scales[pos] = vscales
                self._install_payload(new_base, new_scales)
        else:
            self._place_and_scatter(ids, cf, assign)
        if self._tombstones is not None:
            self._tombstones = np.concatenate(
                [self._tombstones, np.zeros(m, bool)])
        self.n += m
        self._drift_rows += m
        return self.n

    def update(self, indices: ArrayLike, rows: ArrayLike) -> None:
        """Overwrite rows in place by ORIGINAL id (upsert).

        Rows keep their ids but MOVE to their new nearest-centroid
        cluster (the values changed, so the old placement may no longer
        probe well); the vacated slots become slack holes that future
        ``add``/``update`` calls refill.  Updating a tombstoned row
        revives it, matching ``Corpus.update``.

        On mesh handles the new values are scattered IN PLACE at the
        rows' current permuted slots (the same donated per-shard scatter
        as ``Corpus.update`` — no gather, no recompile) WITHOUT moving
        them to their new nearest cluster: exhaustive results are exact
        either way, and the placement staleness is exactly what ``drift``
        counts and ``rebuild()`` repairs.
        """
        import jax

        idx = np.asarray(indices).reshape(-1)
        r = np.asarray(rows)
        if r.ndim != 2 or r.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{r.shape[1] if r.ndim == 2 else r.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        if idx.size != r.shape[0]:
            raise ValueError(f"got {idx.size} indices for {r.shape[0]} rows")
        if idx.size == 0:
            return
        if not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(
                f"update indices must be integers, got dtype {idx.dtype}")
        if idx.min() < 0 or idx.max() >= self.n:
            raise ValueError(
                f"update indices must be in [0, {self.n}); got "
                f"[{idx.min()}, {idx.max()}]")
        if np.unique(idx).size != idx.size:
            raise ValueError("update indices must be unique")
        if not np.issubdtype(r.dtype, np.floating):
            raise ValueError("ClusteredCorpus requires float embeddings")
        cf = np.ascontiguousarray(r, dtype=np.float32)
        if self.mesh is not None:
            from .search import _scatter_rows_sharded

            pos = self.layout.row_pos[idx].astype(np.int64)
            _scatter_rows_sharded(self._sharded, self.storage, self.dim,
                                  cf, pos)
        else:
            assign = assign_rows(cf, self.centroids)
            self._place_and_scatter(idx.astype(np.int64), cf, assign,
                                    free_first=True)
        self._drift_rows += int(idx.size)
        if self._tombstones is not None and self._tombstones[idx].any():
            self._tombstones[idx] = False
            self._perm_mask_dev = None
            if self.mesh is not None:
                self._mesh_mask_dev = None

    def _quantize_native(self, cf: np.ndarray):
        """f32 rows -> (storage-native host values, scales or None)."""
        if self.storage == "int8":
            return _quantize_rows_np(cf)
        if self.storage == "int4":
            from ..kernels.fused_topk import feature_geometry

            ck, dpp, _ = feature_geometry(self.dim)
            return _quantize_rows_int4_np(cf, ck, dpp)
        if self.storage == "bf16":
            import ml_dtypes

            return cf.astype(ml_dtypes.bfloat16), None
        return cf, None

    def _place_and_scatter(self, ids: np.ndarray, cf: np.ndarray,
                           assign: np.ndarray, free_first: bool = False):
        """Place rows with global ids ``ids`` into their assigned
        clusters (``_place``), then scatter the storage-native values
        into the single-device buffers and invalidate the derived
        caches."""
        import jax
        import jax.numpy as jnp

        n_old_padded = self.layout.perm.shape[0]
        pos = self._place(ids, assign, free_first=free_first)
        perm = self.layout.perm
        tile_cluster = self.layout.tile_cluster

        # -- storage-native device scatter (grow first if tiles appended)
        ext = perm.shape[0] - n_old_padded
        vals, scales = self._quantize_native(cf)

        fn = _cached_fn(self._packed_fns, ("scatter", ext, scales is None),
                        _scatter_fn)
        pos_d = jnp.asarray(pos, jnp.int32)
        extra = () if scales is None else (
            self._scales, jnp.asarray(scales, jnp.float32))
        out = jax.block_until_ready(
            fn(self._base, pos_d, jnp.asarray(vals), *extra))
        self._base = out[0]
        if scales is not None:
            self._scales = out[1]
        self._perm_dev = _to_jax(perm, np.dtype(np.int32))
        self._tile_cluster_dev = _to_jax(tile_cluster, np.dtype(np.int32))
        self._live_dev = self._perm_dev >= 0
        self._prepared.clear()
        self._perm_mask_dev = None
        self._dense = None

    def _place(self, ids: np.ndarray, assign: np.ndarray,
               free_first: bool = False) -> np.ndarray:
        """Host-side placement: assign each id a position in the permuted
        layout — its cluster's tile-tail slack first, then CLAIMED dead
        tiles (the ``reserve_tiles`` growth reserve / mesh alignment
        padding, re-labeled to the cluster in place), whole appended
        tiles only when the reserve is exhausted — and install the grown
        ``self.layout``.  Returns the (m,) positions.  ``free_first``
        releases the ids' CURRENT positions back to slack before placing
        (the update path: a moved row's old slot becomes a refillable
        hole, possibly reused within the same batch)."""
        lay = self.layout
        tn = self._tn
        perm = lay.perm.copy()
        counts = lay.counts.copy()
        row_pos = lay.row_pos.copy()
        tile_cluster = lay.tile_cluster.copy()
        if free_first:
            old = row_pos[ids].astype(np.int64)
            perm[old] = -1
            np.subtract.at(counts, tile_cluster[old // tn], 1)
        n_old_padded = perm.shape[0]
        slack_pos = np.flatnonzero(perm < 0)
        slack_cl = tile_cluster[slack_pos // tn]
        # Claimable dead tiles, lowest id first (all their rows are slack
        # by construction — a dead tile never received a live row).
        dead_tiles = list(np.flatnonzero(tile_cluster == -1))

        m = ids.shape[0]
        pos = np.full(m, -1, np.int64)
        append_tiles = []   # cluster ids of tiles appended at the end
        next_pos = n_old_padded
        ext_perm = []
        order = np.argsort(assign, kind="stable")
        for cl in np.unique(assign):
            sel = order[np.searchsorted(assign[order], cl):
                        np.searchsorted(assign[order], cl, side="right")]
            sl = slack_pos[slack_cl == cl]
            take = min(sl.size, sel.size)
            pos[sel[:take]] = sl[:take]
            over = sel[take:]
            while over.size and dead_tiles:
                # claim a reserve tile: re-label it in place, fill its rows
                t = int(dead_tiles.pop(0))
                tile_cluster[t] = cl
                take2 = min(tn, over.size)
                pos[over[:take2]] = t * tn + np.arange(take2,
                                                       dtype=np.int64)
                over = over[take2:]
            if over.size:
                nt = -(-over.size // tn)
                append_tiles.extend([int(cl)] * nt)
                block = np.arange(nt * tn, dtype=np.int64) + next_pos
                pos[over] = block[: over.size]
                ep = np.full(nt * tn, -1, np.int32)
                ep[: over.size] = ids[over]
                ext_perm.append(ep)
                next_pos += nt * tn
            counts[cl] += sel.size
        infill = pos < n_old_padded
        perm[pos[infill]] = ids[np.flatnonzero(infill)].astype(np.int32)
        if ext_perm:
            perm = np.concatenate([perm] + ext_perm)
        if append_tiles:
            tile_cluster = np.concatenate(
                [tile_cluster, np.array(append_tiles, np.int32)])
        top = int(ids.max()) + 1
        if top > row_pos.shape[0]:
            row_pos = np.concatenate([
                row_pos, np.empty(top - row_pos.shape[0], np.int32)])
        row_pos[ids] = pos.astype(np.int32)
        self.layout = ClusterLayout(perm, row_pos, tile_cluster, counts, tn)
        return pos

    def delete(self, indices: ArrayLike) -> int:
        """Tombstone rows by ORIGINAL id; they stop matching immediately
        (mask path — no re-clustering, no re-prep).  Returns the number
        newly deleted."""
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(
                f"delete index out of range for corpus of {self.n} rows"
            )
        if self._tombstones is None:
            self._tombstones = np.zeros(self.n, bool)
        before = int(self._tombstones.sum())
        self._tombstones[idx] = True
        self._perm_mask_dev = None
        if self.mesh is not None:
            self._mesh_mask_dev = None
        return int(self._tombstones.sum()) - before

    @property
    def deleted_count(self) -> int:
        return 0 if self._tombstones is None else int(self._tombstones.sum())

    _perm_mask_dev = None
    _drift_rows = 0
    _striped_for = None  # shard count the layout's tiles are striped for
    _stripe_lt = None    # tiles per shard at stripe time (undo geometry)
    _reserve_tiles = 0   # dead-tile growth reserve maintained on install

    def _route_order(self, q: np.ndarray, metric: Metric):
        """Stable query order grouping rows by their best cluster — the
        host-side mirror of ``ops.cluster.centroid_scores`` ranking (only
        the grouping key matters, so host f32 is fine).  Returns None
        when every query already agrees on a cluster (routing no-op)."""
        cf = np.ascontiguousarray(q, dtype=np.float32)
        cent = np.asarray(self.centroids, np.float32)
        if metric is Metric.COSINE:
            cf = cf / np.maximum(
                np.linalg.norm(cf, axis=1, keepdims=True), 1e-20)
            cn = cent / np.maximum(
                np.linalg.norm(cent, axis=1, keepdims=True), 1e-20)
            s = cf @ cn.T
        elif metric is Metric.EUCLIDEAN:
            s = 2.0 * (cf @ cent.T) - (cent * cent).sum(1)[None, :]
        else:
            s = cf @ cent.T
        best = np.argmax(s, axis=1)
        if (best == best[0]).all():
            return None
        return np.argsort(best, kind="stable")

    def _permuted_mask(self, user_mk: Optional[np.ndarray]):
        """(n_padded,) device bool in permuted space, or None.  Slack rows
        False (harmless — their bias is already -inf)."""
        if user_mk is None and self._tombstones is None:
            return None
        if user_mk is None and self._perm_mask_dev is not None:
            return self._perm_mask_dev  # before the O(n) host combine
        combined = (np.ones(self.n, bool) if user_mk is None
                    else user_mk.astype(bool))
        if self._tombstones is not None:
            combined = combined & ~self._tombstones
        perm = self.layout.perm
        pm = np.zeros(self.layout.n_padded, bool)
        live = perm >= 0
        pm[live] = combined[perm[live]]
        dev = _to_jax(pm, np.dtype(bool))
        if user_mk is None:
            import jax

            self._perm_mask_dev = jax.block_until_ready(dev)
        return dev

    def _dense_view(self):
        """(n_padded, dim) f32 dense values in PERMUTED space (slack rows
        zero), built lazily for ``matmul``.  Costs the f32 bytes once."""
        import jax
        import jax.numpy as jnp

        if self._dense is None:
            from ..kernels.fused_topk import dequant_int4

            base = self._base
            if self.storage == "int8":
                d = base.astype(jnp.float32) * self._scales[:, None]
            elif self.storage == "int4":
                d = dequant_int4(base, self._scales, self.dim)
            elif self.storage == "bf16":
                d = base.astype(jnp.float32)
            else:
                d = base
            self._dense = jax.block_until_ready(jax.jit(lambda x: x)(d)) \
                if d is not base else base
        return self._dense

    _dense = None

    # -- persistence ------------------------------------------------------
    def save(self, path) -> None:
        """Persist to ``path`` (.npz): storage-native permuted payload
        plus the cluster layout and centroids.  Loading never re-clusters
        and never requantizes — codes, layout, and centroids round-trip
        bit-exact, so probed results match the saved handle's exactly.

        Same contract family as ``Corpus.save`` (storage-native bytes,
        tombstones preserved); the payload keeps its interior cluster-tail
        slack rows (they are part of the tile layout).
        """
        arrays = {
            "n": np.int64(self.n),
            "dim": np.int64(self.dim),
            "storage": np.array(self.storage),
            "clusters": np.int64(self.clusters),
            "tn": np.int64(self._tn),
            "perm": self.layout.perm,
            "tile_cluster": self.layout.tile_cluster,
            "counts": self.layout.counts,
            "centroids": np.asarray(self.centroids, np.float32),
        }
        base, scales = self._gather_native_host()
        if self.storage == "bf16":
            arrays["data_u16"] = base.view(np.uint16)
        else:
            arrays["data"] = base
        if scales is not None:
            arrays["scales"] = scales
        if self._tombstones is not None:
            arrays["tombstones"] = self._tombstones
        if self._drift_rows:
            arrays["drift_rows"] = np.int64(self._drift_rows)
        if self._striped_for:
            arrays["striped_for"] = np.int64(self._striped_for)
            arrays["stripe_lt"] = np.int64(self._stripe_lt)
        if self._reserve_tiles:
            arrays["reserve_tiles"] = np.int64(self._reserve_tiles)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path, *, mesh=None,
             config: Optional[SearchConfig] = None) -> "ClusteredCorpus":
        """Rebuild a saved clustered corpus: uploads exactly the saved
        storage-native bytes and layout (no clustering, no quantization).
        ``config`` only steers query-side tiling/precision policy — the
        corpus tile geometry is pinned by the saved layout.  ``mesh=``
        re-shards at load (the layout gains dead alignment tiles if the
        mesh needs them; results are unchanged — dead rows are masked)."""
        import jax
        import ml_dtypes

        with np.load(path, allow_pickle=False) as z:
            storage = str(z["storage"])
            if storage == "bf16":
                base = z["data_u16"].view(ml_dtypes.bfloat16)
            else:
                base = z["data"]
            perm = z["perm"]
            tile_cluster = z["tile_cluster"]
            counts = z["counts"]
            centroids = z["centroids"]
            n = int(z["n"])
            dim = int(z["dim"])
            clusters = int(z["clusters"])
            tn = int(z["tn"])
            scales = z["scales"] if "scales" in z else None
            tomb = z["tombstones"] if "tombstones" in z else None
            drift_rows = int(z["drift_rows"]) if "drift_rows" in z else 0
            striped_for = (int(z["striped_for"])
                           if "striped_for" in z else None)
            stripe_lt = int(z["stripe_lt"]) if "stripe_lt" in z else None
            reserve_tiles = (int(z["reserve_tiles"])
                             if "reserve_tiles" in z else 0)

        self = cls.__new__(cls)
        self.config = resolve(config)
        self.storage = storage
        self.mesh = mesh
        self.n, self.dim = n, dim
        self.dtype = np.dtype(np.float32)
        self._tn = tn
        self.clusters = clusters
        row_pos = np.empty(n, np.int32)
        live = perm >= 0
        row_pos[perm[live]] = np.flatnonzero(live).astype(np.int32)
        self.layout = ClusterLayout(perm, row_pos, tile_cluster, counts, tn)
        self.centroids = jax.block_until_ready(
            _to_jax(centroids, np.dtype(np.float32)))
        # before install: align reads these to undo/skip the stripe
        self._striped_for = striped_for
        self._stripe_lt = stripe_lt
        # saved dead tiles ride the layout itself; the attribute keeps
        # future mesh re-aligns provisioning the same reserve
        self._reserve_tiles = reserve_tiles
        self._install_payload(base, None if scales is None
                              else np.asarray(scales, np.float32))
        self._tombstones = None if tomb is None or not tomb.any() \
            else tomb.astype(bool)
        self._drift_rows = drift_rows
        return self

    def rebuild(
        self,
        *,
        clusters: Optional[int] = None,
        seed: int = 0,
        kmeans_iters: int = 8,
        sample_rows: int = 131072,
    ) -> "ClusteredCorpus":
        """Re-fit centroids on the live rows and re-lay out the corpus —
        drift recovery after heavy ``add``/``update`` traffic (neither
        refits centroids, so probe recall decays as the data moves).

        Storage-native: quantized codes/scales are PERMUTED into the new
        layout, never requantized, so exhaustive results are identical
        before and after; only the probe's tile ranking changes.  Row
        ids and tombstones are stable.  ``clusters=None`` recomputes the
        constructor default from the CURRENT row count.  Prepared forms
        and compiled probe programs rebuild lazily on the next query.
        Works on mesh handles (the new layout is re-sharded).  k-means
        runs on dequantized values (sampled fit + chunked assignment),
        so the f32 transient is one chunk, not the corpus.
        """
        import jax

        n = self.n
        if clusters is None:
            clusters = self._default_clusters(n)
        elif int(clusters) < 1:
            raise ValueError(f"clusters must be >= 1, got {clusters}")

        # -- gather the native payload in ORIGINAL row order (host) ------
        base_host, scales_host = self._gather_native_host()
        old_pos = self.layout.row_pos[:n].astype(np.int64)
        orig = np.ascontiguousarray(base_host[old_pos])
        orig_scales = (None if scales_host is None
                       else np.ascontiguousarray(scales_host[old_pos]))
        del base_host, scales_host

        def deq(rows, sc):
            """Native rows -> f32 values (assignment input)."""
            if self.storage == "int8":
                return rows.astype(np.float32) * sc[:, None]
            if self.storage == "int4":
                from ..kernels.fused_topk import feature_geometry

                ck, _, _ = feature_geometry(self.dim)
                codes = _unpack_int4_np(rows, ck, self.dim)
                return codes.astype(np.float32) * sc[:, None]
            return np.asarray(rows, dtype=np.float32)

        # -- re-fit on live rows, re-assign everything (chunked) ---------
        live_ids = (np.arange(n) if self._tombstones is None
                    else np.flatnonzero(~self._tombstones))
        if live_ids.size == 0:
            live_ids = np.arange(n)  # all tombstoned: fit on the bytes
        cent = self._fit_sampled(
            lambda ids: deq(orig[ids],
                            None if orig_scales is None
                            else orig_scales[ids]),
            live_ids, int(min(clusters, live_ids.size)),
            sample_rows, kmeans_iters, seed)
        self.centroids = cent
        self.clusters = int(cent.shape[0])  # kmeans clamps to sample size
        if self.storage in ("int8", "int4"):
            # upload the native codes for assignment (4-8x less
            # traffic than dequantized f32 chunks); dequant on device
            assign = assign_rows_native(orig, orig_scales, cent,
                                        self.storage, self.dim)
        else:
            assign = np.empty(n, np.int32)
            one = make_assigner(cent)
            chunk = 65536
            for r0 in range(0, n, chunk):
                rows = slice(r0, min(r0 + chunk, n))
                assign[rows] = np.asarray(one(
                    deq(orig[rows],
                        None if orig_scales is None
                        else orig_scales[rows])))
        self.layout = cluster_layout(assign, self.clusters, self._tn)

        # -- permute the NATIVE rows into the new layout ------------------
        perm = self.layout.perm
        live = perm >= 0
        new_base = np.zeros((perm.shape[0], orig.shape[1]), orig.dtype)
        new_base[live] = orig[perm[live]]
        new_scales = None
        if orig_scales is not None:
            new_scales = np.ones(perm.shape[0], np.float32)
            new_scales[live] = orig_scales[perm[live]]
        # fresh layout: nothing to unstripe, stripe it for the mesh
        self._striped_for = None
        self._stripe_lt = None
        self._install_payload(new_base, new_scales)
        self._drift_rows = 0
        return self

    @classmethod
    def from_arrow(cls, column, **kwargs) -> "ClusteredCorpus":
        """Build a clustered corpus straight from an Arrow (or polars)
        embedding column — same extraction as ``Corpus.from_arrow``,
        same constructor keywords (clusters=, storage=, mesh=,
        config=).  The handle then serves ``topk_arrow``/
        ``matmul_arrow`` and the polars ``.pmm`` namespace directly."""
        from ..interop.arrow import extract_embedding_column

        return cls(extract_embedding_column(column), **kwargs)

    def matmul(self, queries: ArrayLike) -> np.ndarray:
        """Raw pairwise Q·Cᵀ panel (n_q, n) in ORIGINAL row order.

        Reference-matmul parity, matching ``Corpus.matmul``: deleted
        (tombstoned) rows still score — the panel is raw by contract.
        The device computes the panel in permuted (cluster-contiguous)
        space; the original-order columns are gathered out on host,
        dropping the interior cluster-tail slack columns.  The gather
        copies, so the result is host-owned."""
        q = np.asarray(queries)
        dt = compute_dtype(q.dtype, self.dtype)
        if q.shape[0] == 0:
            return np.empty((0, self.n), dtype=dt)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"Dimension mismatch: left has "
                f"{q.shape[1] if q.ndim == 2 else q.shape} dimensional "
                f"vectors, right has {self.dim} dimensional vectors"
            )
        row_pos = self.layout.row_pos[: self.n].astype(np.int64)
        if self.mesh is not None:
            from ..parallel.sharded import distributed_matmul

            with annotate("pmm.clustered.matmul"):
                out = distributed_matmul(
                    _to_jax(q, dt), self._sharded, self.mesh, self.config)
                panel = np.asarray(out)
        else:
            from ..kernels.matmul import pairwise_matmul

            dense = self._dense_view()  # permuted (n_padded, dim) f32
            cj = dense if np.dtype(dense.dtype) == dt else dense.astype(dt)
            with annotate("pmm.clustered.matmul"):
                out = pairwise_matmul(_to_jax(q, dt), cj)
                panel = np.asarray(out)
        # Fancy indexing copies: host-owned, slack columns dropped.
        return panel[:, row_pos]

    # -- search -----------------------------------------------------------
    def topk(
        self,
        queries: ArrayLike,
        k: int,
        metric: Union[str, Metric] = "cosine",
        *,
        probe: Union[float, int, None] = None,
        mask: Optional[ArrayLike] = None,
        route: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the clustered corpus.  ``probe`` bounds the corpus
        tiles visited per 256-query block: a float is a fraction of all
        tiles (the bytes-read budget), an int a tile count, None an
        exhaustive scan.  Returns (indices u32, scores f64) in ORIGINAL
        row ids, exactly like ``Corpus.topk``.

        ``route`` (default True) reorders multi-block probed batches so
        queries wanting the same cluster share a probe block: the tile
        budget is a per-block union, so coherent blocks waste less of it
        on other queries' tiles (a diverse 1000-query batch dilutes each
        query's effective budget otherwise).  Results come back in the
        caller's row order; exhaustive scans and single-block batches
        are unaffected.  Pass ``route=False`` for probe-block-stable
        results across calls with different query orders.

        Compute is f32 by design: the constructor stores the corpus
        f32-or-quantized (clustering is an approximation tier), so f64
        queries are downcast here — unlike ``Corpus``, which keeps an
        exact f64 path for f64 data.  Exactness claims (``probe=None``,
        "exact over visited rows") are relative to this f32/quantized
        storage."""
        from ..kernels.fused_topk import query_block_rows

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
        kk = min(int(k), self.n)
        if kk <= 0:
            return (
                np.empty((q.shape[0], 0), np.uint32),
                np.empty((q.shape[0], 0), np.float64),
            )
        if route and probe is not None:
            tm_r = query_block_rows(q.shape[0], self.config)
            order = (self._route_order(q, metric)
                     if q.shape[0] > tm_r else None)
            if order is not None:
                i_r, v_r = self.topk(q[order], k, metric, probe=probe,
                                     mask=mask, route=False)
                inv = np.empty_like(order)
                inv[order] = np.arange(order.size)
                return (np.ascontiguousarray(i_r[inv]),
                        np.ascontiguousarray(v_r[inv]))
        if self.mesh is not None:
            return self._mesh_topk(q, kk, metric, probe, user_mk)
        p, exhaustive = resolve_probe(probe, self.layout.n_tiles)
        half_q = (q.dtype.itemsize == 2
                  and np.issubdtype(q.dtype, np.floating)
                  or str(q.dtype) == "bfloat16")
        qj = _to_jax(q, q.dtype if half_q else np.dtype(np.float32))
        cp, cbp = self._prepared_for(metric)
        tm = query_block_rows(q.shape[0], self.config)
        mkj = self._permuted_mask(user_mk)
        masked = mkj is not None

        run_cfg = self.config.with_updates(
            precision=self._effective_precision())
        p_key = None if exhaustive else p
        key = (kk, metric, run_cfg, self._tn, p_key, tm, masked)
        fn = _cached_fn(self._packed_fns, key, _probed_fn)
        args = (qj, cp, cbp, self.centroids, self._tile_cluster_dev,
                self._perm_dev) + (() if mkj is None else (mkj,))
        with annotate(f"pmm.clustered.topk.{metric.value}"):
            packed = np.asarray(fn(*args))
        v, i = _unpack_pair(packed, kk)
        return i.astype(np.uint32), v.astype(np.float64)
