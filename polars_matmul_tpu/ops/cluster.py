"""Corpus clustering for probed (IVF-style) search.

The reference scans every corpus row on every query (faer GEMM over the
full matrix, reference src/metrics.rs:40-255); the scan already reduced
that to one streamed pass, which leaves memory bandwidth as the binding
cost for big-corpus serving (reading N*dim bytes per batch).  Probed
search attacks the bytes themselves: corpus rows are k-means clustered
and laid out so each cluster owns whole corpus tiles; at query time a
tiny (m x n_clusters) centroid matmul ranks the tiles and only the top
``P`` per query block are visited (the scan gathers just the listed
tiles; unlisted tiles are never read).  Exact over the visited
rows; recall vs an exhaustive scan is governed by ``P`` and how well the
corpus clusters.

Pure functions only: k-means and tile scoring are jittable JAX; the
one-shot layout builder is NumPy (host-side, construction time).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .metrics import Metric

# The clustering products run at full f32 precision: on the GPU an f32
# product left at the default precision runs in TF32.
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class ClusterLayout(NamedTuple):
    """Host-side description of a clustered corpus layout.

    perm       (n_padded,) int32: permuted position -> original row id,
               -1 on slack rows (cluster tail padding to whole tiles).
    row_pos    (n,) int32: original row id -> permuted position.
    tile_cluster (n_tiles,) int32: cluster id owning each corpus tile.
    counts     (n_clusters,) int64: rows per cluster.
    tn         tile height the layout is built for.
    """

    perm: np.ndarray
    row_pos: np.ndarray
    tile_cluster: np.ndarray
    counts: np.ndarray
    tn: int

    @property
    def n_tiles(self) -> int:
        return self.tile_cluster.shape[0]

    @property
    def n_padded(self) -> int:
        return self.perm.shape[0]


def _kmeanspp_init(key, x, n_clusters: int):
    """k-means++ D^2-weighted greedy seeding.  Uniform-random init can
    drop two seeds into one dense blob and leave a far blob seedless —
    Lloyd's then converges with distinct clusters merged (observed on
    10-sigma-separated Gaussians), which directly costs probe recall.
    Cost: one |x - c_t|^2 update per seed = the work of a single
    assignment pass overall.
    """
    n = x.shape[0]
    xsq = jnp.sum(x * x, axis=1)
    key, k0 = jax.random.split(key)
    i0 = jax.random.randint(k0, (), 0, n)
    cents = jnp.zeros((n_clusters, x.shape[1]), jnp.float32).at[0].set(x[i0])
    d2 = jnp.maximum(xsq - 2.0 * _mm(x, x[i0]) + xsq[i0], 0.0)

    def step(carry, key_t):
        cents, d2, t = carry
        idx = jax.random.categorical(key_t, jnp.log(d2 + 1e-30))
        cnew = x[idx]
        cents = cents.at[t].set(cnew)
        nd = jnp.maximum(xsq - 2.0 * _mm(x, cnew) + jnp.sum(cnew * cnew),
                         0.0)
        return (cents, jnp.minimum(d2, nd), t + 1), None

    keys = jax.random.split(key, n_clusters - 1)
    (cents, _, _), _ = jax.lax.scan(
        step, (cents, d2, jnp.int32(1)), keys)
    return cents


def kmeans(x, n_clusters: int, *, iters: int = 8, seed: int = 0):
    """Lloyd k-means with k-means++ seeding (euclidean geometry, the
    standard IVF coarse quantizer for every metric — cosine callers pass
    normalized rows).

    Returns (centroids (C, dim) f32, assignments (n,) int32).  Clusters
    that empty out keep their previous centroid.  Jittable and
    backend-agnostic; assignment uses the ``-2 x.c + |c|^2`` expansion so
    the hot op is one (n, C) matmul per iteration.
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    n_clusters = int(min(n_clusters, n))
    key = jax.random.PRNGKey(seed)
    if n_clusters == 1:
        cent0 = jnp.mean(x, axis=0, keepdims=True)
    else:
        cent0 = _kmeanspp_init(key, x, n_clusters)

    def assign(cent):
        d = -2.0 * _mm(x, cent.T) + jnp.sum(cent * cent, axis=1)[None, :]
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    def step(cent, _):
        a = assign(cent)
        # segment_sum, not a one-hot matmul: the (n, C) one-hot would cost
        # n*C*4 bytes (tens of GB at corpus scale); the scatter-add costs
        # only the (C, dim) accumulator.
        sums = jax.ops.segment_sum(x, a, num_segments=n_clusters)
        cnt = jax.ops.segment_sum(
            jnp.ones((n,), jnp.float32), a, num_segments=n_clusters)
        new = jnp.where(cnt[:, None] > 0,
                        sums / jnp.maximum(cnt, 1.0)[:, None], cent)
        return new, None

    cent, _ = jax.lax.scan(step, cent0, None, length=int(iters))
    return cent, assign(cent)


def make_assigner(centroids):
    """One jitted nearest-centroid chunk assigner, reusable across many
    chunks.  Callers that loop over host-side chunks must hoist this out
    of the loop — a fresh closure per chunk re-traces and recompiles the
    same program every iteration."""
    cent = jnp.asarray(centroids, jnp.float32)
    csq = jnp.sum(cent * cent, axis=1)[None, :]

    @jax.jit
    def one(chunk):
        x = chunk.astype(jnp.float32)
        d = -2.0 * _mm(x, cent.T) + csq
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    return one


def make_assigner_native(centroids, storage: str, dim: int):
    """Chunk assigner over STORAGE-NATIVE rows (int8 codes or int4
    nibble-packed) + per-row scales, dequantized ON DEVICE.  Chunked
    assignment then uploads quantized bytes — 4x (int8) / 8x (int4)
    less host->device traffic than f32 chunks, which dominates
    corpus-scale ingestion through a remote transport (the 10M x 768
    north-star build moved 30 GB of f32 just to assign clusters)."""
    cent = jnp.asarray(centroids, jnp.float32)
    csq = jnp.sum(cent * cent, axis=1)[None, :]

    @jax.jit
    def one(rows, scales):
        if storage == "int4":
            from ..kernels.fused_topk import dequant_int4

            x = dequant_int4(rows, scales, dim)
        else:
            x = rows.astype(jnp.float32) * scales[:, None]
        d = -2.0 * _mm(x, cent.T) + csq
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    return one


def assign_rows_native(codes, scales, centroids, storage: str, dim: int,
                       *, chunk_rows: int = 65536) -> np.ndarray:
    """assign_rows over quantized host rows: host-sliced chunks, device
    dequant + nearest-centroid.  Returns host (n,) int32."""
    one = make_assigner_native(centroids, storage, dim)
    n = codes.shape[0]
    out = np.empty(n, np.int32)
    for r0 in range(0, n, chunk_rows):
        sl = slice(r0, min(r0 + chunk_rows, n))
        out[sl] = np.asarray(one(
            np.ascontiguousarray(codes[sl]),
            np.ascontiguousarray(scales[sl], dtype=np.float32)))
    return out


def assign_rows(c, centroids, *, chunk_rows: int = 65536) -> np.ndarray:
    """Nearest-centroid assignment of the FULL corpus, in row chunks (the
    transient (chunk, C) distance panel stays bounded regardless of n).
    Returns host (n,) int32 — the layout builder is host-side anyway.

    A HOST corpus is sliced on host and uploaded one chunk at a time:
    `jnp.asarray(c)` here once put the whole corpus on device, which is
    exactly what chunking exists to avoid (a 10M x 768 f32 corpus is
    28.6 GB, more than the device may have free).  An already-
    device-resident corpus keeps the on-device dynamic_slice path."""
    one = make_assigner(centroids)
    n = c.shape[0]
    on_host = not isinstance(c, jax.Array)
    if not on_host:
        c = jnp.asarray(c)
    out = np.empty(n, np.int32)
    row0 = 0
    while row0 < n:
        rows = min(chunk_rows, n - row0)
        if on_host:
            chunk = np.ascontiguousarray(c[row0:row0 + rows])
        else:
            chunk = jax.lax.dynamic_slice_in_dim(c, row0, rows, axis=0)
        out[row0:row0 + rows] = np.asarray(one(chunk))
        row0 += rows
    return out


def cluster_layout(assignments: np.ndarray, n_clusters: int,
                   tn: int) -> ClusterLayout:
    """Group rows by cluster and pad each cluster to whole ``tn``-row
    tiles, so a tile belongs to exactly one cluster and tile selection is
    a gather of cluster scores.  Empty clusters own zero tiles.
    """
    assignments = np.asarray(assignments)
    n = assignments.shape[0]
    counts = np.bincount(assignments, minlength=n_clusters).astype(np.int64)
    cap = (counts + tn - 1) // tn * tn
    offsets = np.concatenate([[0], np.cumsum(cap)])
    n_padded = int(offsets[-1])

    order = np.argsort(assignments, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    a_sorted = assignments[order]
    pos_of_order = (offsets[a_sorted]
                    + np.arange(n, dtype=np.int64) - starts[a_sorted])

    perm = np.full(n_padded, -1, np.int32)
    perm[pos_of_order] = order
    row_pos = np.empty(n, np.int32)
    row_pos[order] = pos_of_order
    tile_cluster = np.repeat(
        np.arange(n_clusters, dtype=np.int32), cap // tn)
    return ClusterLayout(perm, row_pos, tile_cluster, counts, int(tn))


def permute_rows(c, perm):
    """Device gather into the clustered layout: slack rows (-1) are zero.
    Works for f32/f16/bf16 value rows and int8 code rows alike."""
    c = jnp.asarray(c)
    perm = jnp.asarray(perm)
    safe = jnp.clip(perm, 0, c.shape[0] - 1)
    out = jnp.take(c, safe, axis=0)
    live = (perm >= 0)
    return jnp.where(live[:, None] if c.ndim == 2 else live, out,
                     jnp.zeros((), c.dtype))


def centroid_scores(q, centroids, metric) -> "object":
    """(m, C) cluster relevance in maximize orientation for this metric.

    cosine:    normalized-q . normalized-centroid  (direction match)
    dot:       q . centroid  (magnitude-aware, like the metric itself)
    euclidean: 2 q.c - |c|^2  (= -|q - c|^2 up to the rank-invariant |q|^2)
    """
    metric = Metric.parse(metric)
    q = jnp.asarray(q, jnp.float32)
    cent = jnp.asarray(centroids, jnp.float32)
    if metric is Metric.COSINE:
        qn = jnp.linalg.norm(q, axis=1, keepdims=True)
        cn = jnp.linalg.norm(cent, axis=1, keepdims=True)
        q = q / jnp.maximum(qn, 1e-20)
        cent = cent / jnp.maximum(cn, 1e-20)
        return _mm(q, cent.T)
    if metric is Metric.EUCLIDEAN:
        return 2.0 * _mm(q, cent.T) - jnp.sum(cent * cent, axis=1)[None, :]
    return _mm(q, cent.T)


@functools.partial(jax.jit, static_argnames=("p", "tm", "metric_v"))
def probe_tiles(q, centroids, tile_cluster, *, p: int, tm: int,
                metric_v: str):
    """(n_query_blocks, p) ascending distinct corpus-tile ids to visit.

    Ranks clusters per query by ``centroid_scores``, reduces to per-block
    scores with a max over the block's rows (a tile top-ranked for ANY
    query in the block must be visited — the kernel scans per block), and
    takes the best ``p`` tiles.  jax.lax.top_k breaks score ties toward
    lower tile ids; the final ascending sort restores the kernel's
    lowest-global-index-wins tie contract.

    Tiles with cluster id -1 are DEAD (mesh shard-alignment padding):
    they rank -inf and are only listed once live tiles run out — their
    rows are slack, masked -inf by the caller, so visiting them is
    harmless, just wasted bytes.
    """
    m = q.shape[0]
    mp = (m + tm - 1) // tm * tm
    s = centroid_scores(q, centroids, metric_v)          # (m, C)
    s = jnp.pad(s, ((0, mp - m), (0, 0)),
                constant_values=-np.inf)                 # pad rows inert
    sb = jnp.max(s.reshape(mp // tm, tm, -1), axis=1)    # (QB, C)
    tcl = jnp.asarray(tile_cluster)
    ts = sb[:, jnp.clip(tcl, 0, None)]                   # (QB, n_tiles)
    ts = jnp.where(tcl[None, :] >= 0, ts, -np.inf)
    _, tid = jax.lax.top_k(ts, p)
    return jnp.sort(tid, axis=1).astype(jnp.int32)


def resolve_probe(probe, n_tiles: int) -> Tuple[int, bool]:
    """User ``probe=`` -> (tile count P, is_exhaustive).

    float in (0, 1] = fraction of the corpus' tiles (the honest cost
    model: bytes read scale with P/n_tiles); int >= 1 = explicit tile
    count.  None / covering values mean an exhaustive dense scan.
    """
    if probe is None:
        return n_tiles, True
    if isinstance(probe, bool):
        raise TypeError("probe must be a float fraction, an int tile "
                        "count, or None")
    if isinstance(probe, float):
        if not 0.0 < probe <= 1.0:
            raise ValueError(f"probe fraction must be in (0, 1], "
                             f"got {probe}")
        p = max(1, int(np.ceil(probe * n_tiles)))
    else:
        p = int(probe)
        if p < 1:
            raise ValueError(f"probe tile count must be >= 1, got {p}")
    p = min(p, n_tiles)
    return p, p >= n_tiles
