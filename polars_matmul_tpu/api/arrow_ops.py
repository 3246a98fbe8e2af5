"""The two public operations on Arrow columns.

This is the boundary the Polars namespace calls through (Polars Series
round-trip to Arrow zero-copy), and it is directly usable with pyarrow —
so the full API contract is testable without polars installed.

Behavioural parity with the reference orchestrators
(src/matmul.rs:295-315, 473-519):
- empty left column  -> typed empty result (not an error)
- empty corpus       -> "Empty series" error
- both-f32 rule for compute dtype
- k clamped to corpus size
- top-k scores always widened to f64

pyarrow is imported when one of these functions is called, so the
package imports without it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..config import SearchConfig
from ..ops.metrics import Metric
from . import search


def _arrow():
    """(pyarrow, interop.arrow); raises a clear ImportError without
    pyarrow."""
    from ..interop import arrow as ai

    return ai.pa, ai


def _as_array(col: "Union[pa.Array, pa.ChunkedArray]") -> "pa.Array":
    pa, _ = _arrow()
    if isinstance(col, pa.ChunkedArray):
        return col.combine_chunks()
    return col


def _mask_to_np(mask):
    if mask is None:
        return None
    pa, _ = _arrow()
    if isinstance(mask, (pa.Array, pa.ChunkedArray)):
        return np.asarray(_as_array(mask).fill_null(False)).astype(bool)
    return np.asarray(mask).astype(bool)


def topk_arrow(
    left: "Union[pa.Array, pa.ChunkedArray]",
    corpus: "Union[pa.Array, pa.ChunkedArray, search.Corpus]",
    k: int,
    metric: Union[str, Metric] = "cosine",
    *,
    mask: "Union[pa.Array, pa.ChunkedArray, np.ndarray, None]" = None,
    probe: Union[float, int, None] = None,
    config: Optional[SearchConfig] = None,
) -> "pa.Array":
    """Arrow List/FixedSizeList embeddings -> List[Struct{index, score}].

    ``corpus`` may also be a resident ``Corpus`` or ``ClusteredCorpus``
    handle (built with ``Corpus.from_arrow`` or from matrices): the
    serving pattern — upload and prepare once, query many times, straight
    from Arrow columns.  ``probe=`` (ClusteredCorpus only) bounds the
    corpus tiles visited per query block.

    ``mask`` (boolean column or ndarray, length n_corpus) enables filtered
    search; Arrow nulls in the mask count as excluded.
    """
    from ..utils.profiling import annotate
    from .clustered import ClusteredCorpus

    pa, ai = _arrow()
    Metric.parse(metric)  # validate metric before touching data
    left = _as_array(left)
    clustered = isinstance(corpus, ClusteredCorpus)
    if probe is not None and not clustered:
        raise ValueError(
            "probe= requires a ClusteredCorpus handle (only a clustered "
            "layout knows which corpus tiles a probe may skip)"
        )
    if isinstance(corpus, search.Corpus) or clustered:
        if config is not None:
            raise ValueError(
                "config= has no effect with a resident Corpus — the "
                "handle's own config governs (pass config= to Corpus)"
            )
        if len(left) == 0:
            return ai.empty_topk_arrow()
        dt = ai.promote_pair(ai._value_type(left),
                             pa.from_numpy_dtype(corpus.dtype))
        with annotate("pmm.extract"):
            q = ai.extract_matrix(left, dt)
        kw = {"probe": probe} if clustered else {}
        idx, scores = corpus.topk(q, k, metric, mask=_mask_to_np(mask),
                                  **kw)
        with annotate("pmm.assemble"):
            return ai.topk_to_arrow(idx, scores)
    corpus = _as_array(corpus)
    if len(left) == 0:
        return ai.empty_topk_arrow()
    if len(corpus) == 0:
        raise ValueError("Empty series")
    dt = ai.promote_pair(ai._value_type(left), ai._value_type(corpus))
    with annotate("pmm.extract"):
        q = ai.extract_matrix(left, dt)
        c = ai.extract_matrix(corpus, dt)
    mk = _mask_to_np(mask)
    idx, scores = search.topk(q, c, k, metric, mask=mk, config=config)
    with annotate("pmm.assemble"):
        return ai.topk_to_arrow(idx, scores)


def matmul_arrow(
    left: "Union[pa.Array, pa.ChunkedArray]",
    corpus: "Union[pa.Array, pa.ChunkedArray]",
    *,
    flatten: bool = False,
    config: Optional[SearchConfig] = None,
) -> "pa.Array":
    """Arrow embeddings -> FixedSizeList[n_corpus] of pairwise dot products
    (or a flat row-major column when ``flatten`` — reference
    __init__.py:177-181).  ``corpus`` may be a resident ``Corpus`` or
    ``ClusteredCorpus`` handle (original row order either way)."""
    from .clustered import ClusteredCorpus

    pa, ai = _arrow()
    left = _as_array(left)
    if isinstance(corpus, (search.Corpus, ClusteredCorpus)):
        if config is not None:
            raise ValueError(
                "config= has no effect with a resident Corpus — the "
                "handle's own config governs (pass config= to Corpus)"
            )
        # promote_pair returns an np.dtype (both-f32 rule)
        dt = ai.promote_pair(ai._value_type(left),
                             pa.from_numpy_dtype(corpus.dtype))
        if len(left) == 0:
            return ai.empty_matrix_arrow(dt)
        out = corpus.matmul(ai.extract_matrix(left, dt))
        if flatten:
            return pa.array(np.ascontiguousarray(out).reshape(-1))
        return ai.matrix_to_arrow(out)
    corpus = _as_array(corpus)
    if len(left) == 0:
        if len(corpus) == 0:
            dt = np.dtype(np.float64)
        else:
            dt = ai.promote_pair(ai._value_type(left), ai._value_type(corpus))
        return ai.empty_matrix_arrow(dt)
    if len(corpus) == 0:
        raise ValueError("Empty series")
    dt = ai.promote_pair(ai._value_type(left), ai._value_type(corpus))
    q = ai.extract_matrix(left, dt)
    c = ai.extract_matrix(corpus, dt)
    out = search.matmul(q, c, config=config)
    if flatten:
        return pa.array(np.ascontiguousarray(out).reshape(-1))
    return ai.matrix_to_arrow(out)
