"""Pure-JAX reference implementations of the two public operations.

These are the correctness oracle for the scan in ``kernels.fused_topk``
(SURVEY.md §7 layer 2) and the f64 compute path.  Every product runs at
HIGHEST precision: an f32 dot left at the default would run in TF32 on the
GPU.  Semantics replicate the reference Rust core exactly:

- ``pairwise_scores``  == reference ``compute_similarity_matrix[_f32]``
  (src/metrics.rs:258-365): cosine divides the raw dot products by the norm
  product with zero-norm guards (eps 1e-10 f64 / 1e-6 f32, degenerate rows or
  columns score 0.0); euclidean is sqrt(max(0, |q|^2 + |c|^2 - 2 q.c)).
- ``topk_search`` == the fused normalize -> matmul -> select pipeline
  (src/matmul.rs:420-471 + src/topk.rs:6-75), with deterministic
  lowest-index-wins tie-breaking (the reference's quickselect is unstable on
  ties; SURVEY.md §7 hard part #1 directs us to define lax.top_k's order as
  the contract).

Everything here is jit-friendly: static shapes, no Python control flow on
traced values.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .metrics import Metric, cosine_eps

def _dot(q: jax.Array, c: jax.Array) -> jax.Array:
    """Q . C^T at full precision, accumulated in the input dtype."""
    return jax.lax.dot_general(
        q,
        c,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=q.dtype,
    )


def pairwise_scores(
    q: jax.Array,
    c: jax.Array,
    metric: Metric = Metric.COSINE,
) -> jax.Array:
    """Dense (n_queries, n_corpus) score matrix for the given metric.

    The oracle for the scan; the f32 top-k path never materializes this
    matrix.
    """
    metric = Metric.parse(metric)
    d = _dot(q, c)
    if metric is Metric.DOT:
        return d
    if metric is Metric.COSINE:
        eps = cosine_eps(q.dtype)
        qn = jnp.sqrt(jnp.sum(q * q, axis=1))
        cn = jnp.sqrt(jnp.sum(c * c, axis=1))
        denom_ok = (qn[:, None] > eps) & (cn[None, :] > eps)
        denom = qn[:, None] * cn[None, :]
        # Avoid division by ~0 even where masked out.
        safe = jnp.where(denom_ok, denom, jnp.ones_like(denom))
        return jnp.where(denom_ok, d / safe, jnp.zeros_like(d))
    # Euclidean: sqrt(max(0, |q|^2 + |c|^2 - 2 q.c))  (metrics.rs:302-307)
    qsq = jnp.sum(q * q, axis=1)
    csq = jnp.sum(c * c, axis=1)
    sq = qsq[:, None] + csq[None, :] - 2.0 * d
    return jnp.sqrt(jnp.maximum(sq, 0.0))


def topk_from_scores(
    scores: jax.Array, k: int, higher_is_better: bool
) -> Tuple[jax.Array, jax.Array]:
    """Select top-k per row from a dense score matrix.

    Returns (values, indices) with values sorted best-first (descending for
    similarities, ascending for distances — reference topk.rs:18-30) and
    lowest-index-wins on ties (lax.top_k contract).
    """
    if higher_is_better:
        vals, idx = jax.lax.top_k(scores, k)
    else:
        neg, idx = jax.lax.top_k(-scores, k)
        vals = -neg
    return vals, idx


@partial(jax.jit, static_argnames=("k", "metric"))
def topk_search(
    q: jax.Array,
    c: jax.Array,
    k: int,
    metric: Metric = Metric.COSINE,
    *,
    mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Fused search: returns ((n_queries, k) scores, (n_queries, k) indices).

    ``k`` must already be clamped to ``c.shape[0]`` by the caller (the
    reference clamps at matmul.rs:443,463); this function is shape-static.
    Scores keep the compute dtype; the API layer widens to f64 for output
    (reference matmul.rs:446-447).  ``mask`` (n_corpus,) bool excludes
    corpus rows from selection (filtered search — no reference analog);
    slots beyond the number of matching rows carry sentinel scores
    (-inf similarity / +inf distance) and int32-max indices — the same
    contract as the scan, so callers can detect unfilled slots
    uniformly.
    """
    metric = Metric.parse(metric)
    scores = pairwise_scores(q, c, metric)
    if mask is not None:
        worst = -jnp.inf if metric.higher_is_better else jnp.inf
        scores = jnp.where(mask[None, :], scores, worst)
    vals, idx = topk_from_scores(scores, k, metric.higher_is_better)
    if mask is not None:
        # lax.top_k returns a REAL row index for the -inf slots; emit the
        # index sentinel so excluded rows never leak into results
        idx = jnp.where(vals == worst, jnp.iinfo(jnp.int32).max, idx)
    return vals, idx.astype(jnp.int32)
