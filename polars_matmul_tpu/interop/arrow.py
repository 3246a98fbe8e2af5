"""Arrow <-> NumPy/JAX interchange (needs pyarrow; imported on first use).

Replacement for the reference's Rust marshaling layer
(src/matmul.rs:22-286):

- ``extract_matrix``: embedding column (Arrow ``FixedSizeList`` — the
  reference's zero-copy path, matmul.rs:39-95 — or ragged ``List`` — the copy
  fallback, matmul.rs:231-286) -> dense row-major (n, dim) ndarray.
  FixedSizeList with no nulls is a zero-copy buffer view; List and
  null-bearing columns are packed (nulls become 0.0, matmul.rs:192,224,251,280)
  by the C++ native packer when available, else a vectorized NumPy path.
- ``topk_to_arrow``: (n, k) score/index device arrays -> Arrow
  ``List[Struct{index:u32, score:f64}]`` built from two flat child buffers
  plus one offsets buffer in one shot — deliberately NOT the reference's
  per-query DataFrame loop (matmul.rs:497-518), which SURVEY.md §2 C9 flags
  as an inefficiency not to replicate.
- ``matrix_to_arrow``: (m, n) scores -> Arrow ``FixedSizeList`` column
  (reference vec_to_array_series, matmul.rs:100-125).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import pyarrow as pa
except ImportError as e:  # the package itself imports without pyarrow
    raise ImportError(
        "polars_matmul_tpu's Arrow functions need pyarrow "
        "(pip install pyarrow); the NumPy API works without it"
    ) from e

from .native import native_pack_list

_FLOAT_TYPES = {
    pa.float16(): np.float16,
    pa.float32(): np.float32,
    pa.float64(): np.float64,
}


class ExtractError(ValueError):
    """Raised for malformed embedding columns (mirrors reference
    PolarsError::ComputeError strings, matmul.rs:134-271)."""


def _value_type(arr: pa.Array):
    t = arr.type
    if pa.types.is_fixed_size_list(t) or pa.types.is_list(t) or \
            pa.types.is_large_list(t):
        return t.value_type
    raise ExtractError(
        f"Expected a List or FixedSizeList column, got {t}"
    )


def _target_dtype(value_type) -> np.dtype:
    """Compute dtype for one column: f32 stays f32, everything else -> f64.

    The both-f32 rule (matmul.rs:13-19) is applied across the two columns by
    the caller via ``promote_pair``.
    """
    if value_type == pa.float32():
        return np.dtype(np.float32)
    return np.dtype(np.float64)


def promote_pair(left_vt, right_vt) -> np.dtype:
    """Both-f32 rule: compute in f32 iff *both* columns are f32
    (reference matmul.rs:13-19, 308, 427); otherwise f64."""
    if left_vt == pa.float32() and right_vt == pa.float32():
        return np.dtype(np.float32)
    return np.dtype(np.float64)


def extract_embedding_column(column) -> np.ndarray:
    """Arrow (or polars) embedding column -> dense (n, dim) matrix in its
    promoted dtype — the shared ``from_arrow`` front door for both handle
    types (Corpus, ClusteredCorpus)."""
    if hasattr(column, "to_arrow"):  # polars Series
        column = column.to_arrow()
    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    dt = promote_pair(_value_type(column), _value_type(column))
    return extract_matrix(column, dt)


def extract_matrix(
    arr: pa.Array | pa.ChunkedArray,
    dtype: Optional[np.dtype] = None,
) -> np.ndarray:
    """Extract a dense (n_rows, dim) row-major matrix from an Arrow column.

    Zero-copy when the column is a single-chunk FixedSizeList of the target
    dtype with no nulls (the reference's ``try_extract_contiguous`` fast
    path); otherwise packs with nulls -> 0.0.
    """
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()

    n = len(arr)
    if n == 0:
        raise ExtractError("Empty series")

    vt = _value_type(arr)
    if vt not in _FLOAT_TYPES:
        # Integer / other numeric embeddings: cast like the reference's
        # series_to_matrix cast-to-float fallback.
        if not pa.types.is_integer(vt) and not pa.types.is_floating(vt):
            raise ExtractError(f"Unsupported embedding value type: {vt}")
    if dtype is None:
        dtype = _target_dtype(vt)
    dtype = np.dtype(dtype)

    if pa.types.is_fixed_size_list(arr.type):
        dim = arr.type.list_size
        if dim == 0:
            raise ExtractError("Zero-dimensional vectors")
        values = arr.values  # flat child of length >= n*dim (offset-aware)
        # Slice the child to this array's window.
        values = values.slice(arr.offset * dim, n * dim)
        if arr.null_count == 0 and values.null_count == 0:
            flat = np.asarray(values)  # zero-copy for primitive arrays
            if flat.dtype != dtype:
                flat = flat.astype(dtype)  # cast path (copy)
            return np.ascontiguousarray(flat.reshape(n, dim))
        # Null-bearing fixed-size list: fill nulls with 0.0.
        flat = np.asarray(values.fill_null(0)).astype(dtype, copy=False)
        out = flat.reshape(n, dim).copy()
        if arr.null_count:
            row_valid = np.asarray(arr.is_valid())
            out[~row_valid] = 0.0
        return out

    # Ragged List path (reference list_chunked_to_matrix, matmul.rs:231-286):
    # dim inferred from the first non-null row; short rows zero-padded, long
    # rows truncated? The reference errors on inconsistent rows implicitly via
    # ndarray shape; we enforce equal lengths and fill null rows with zeros.
    offsets = np.asarray(arr.offsets)
    first_valid = None
    validity = np.asarray(arr.is_valid()) if arr.null_count else None
    if validity is not None:
        nz = np.nonzero(validity)[0]
        if len(nz) == 0:
            raise ExtractError("First element is null")
        first_valid = int(nz[0])
        if first_valid != 0 and not validity[0]:
            raise ExtractError("First element is null")
    else:
        first_valid = 0
    dim = int(offsets[first_valid + 1] - offsets[first_valid])
    if dim == 0:
        raise ExtractError("Zero-dimensional vectors")

    lengths = np.diff(offsets)
    if validity is None and np.all(lengths == dim):
        values = arr.values.slice(int(offsets[0]), int(n * dim))
        if values.null_count == 0:
            flat = np.asarray(values)
            if flat.dtype != dtype:
                flat = flat.astype(dtype)
            return np.ascontiguousarray(flat.reshape(n, dim))

    packed = native_pack_list(
        np.asarray(arr.values.fill_null(0)).astype(dtype, copy=False),
        offsets.astype(np.int64),
        validity,
        n,
        dim,
    )
    if packed is not None:
        return packed

    # Pure-NumPy fallback packer.
    out = np.zeros((n, dim), dtype=dtype)
    flat = np.asarray(arr.values.fill_null(0)).astype(dtype, copy=False)
    for i in range(n):
        if validity is not None and not validity[i]:
            continue
        s, e = int(offsets[i]), int(offsets[i + 1])
        ln = min(e - s, dim)
        if e - s != dim:
            raise ExtractError(
                f"Dimension mismatch: row {i} has {e - s} dimensional "
                f"vectors, expected {dim}"
            )
        out[i, :ln] = flat[s : s + ln]
    return out


def column_dim(arr: pa.Array | pa.ChunkedArray) -> int:
    """Vector dimension of an embedding column (0 rows -> 0)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_fixed_size_list(arr.type):
        return int(arr.type.list_size)
    if len(arr) == 0:
        return 0
    offsets = np.asarray(arr.offsets)
    return int(offsets[1] - offsets[0])


def topk_to_arrow(indices: np.ndarray, scores: np.ndarray) -> pa.Array:
    """(n, k) arrays -> Arrow List[Struct{index: u32, score: f64}].

    Flat children + one offsets buffer; no per-row allocation.
    Scores are always widened to f64 (reference matmul.rs:446-447).
    """
    n, k = indices.shape
    idx_child = pa.array(
        np.ascontiguousarray(indices, dtype=np.uint32).reshape(-1),
        type=pa.uint32(),
    )
    score_child = pa.array(
        np.ascontiguousarray(scores, dtype=np.float64).reshape(-1),
        type=pa.float64(),
    )
    struct = pa.StructArray.from_arrays(
        [idx_child, score_child], names=["index", "score"]
    )
    offsets = pa.array(
        (np.arange(n + 1, dtype=np.int64) * k).astype(np.int32),
        type=pa.int32(),
    )
    return pa.ListArray.from_arrays(offsets, struct)


def empty_topk_arrow() -> pa.Array:
    """Typed empty result for 0 queries (reference matmul.rs:479-487)."""
    struct_t = pa.struct([("index", pa.uint32()), ("score", pa.float64())])
    return pa.array([], type=pa.list_(struct_t))


def matrix_to_arrow(scores: np.ndarray) -> pa.Array:
    """(m, n) scores -> Arrow FixedSizeList[n] column (zero-copy child)."""
    m, n = scores.shape
    flat = pa.array(np.ascontiguousarray(scores).reshape(-1))
    return pa.FixedSizeListArray.from_arrays(flat, n)


def empty_matrix_arrow(dtype: np.dtype) -> pa.Array:
    """Typed empty matmul result (reference matmul.rs:297-305: List(inner))."""
    inner = pa.float32() if np.dtype(dtype) == np.float32 else pa.float64()
    return pa.array([], type=pa.list_(inner))
