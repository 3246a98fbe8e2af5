"""Exact top-k search as one XLA scan over corpus slabs.

This replaces the reference's three separate passes (faer GEMM
src/metrics.rs:40-255, dense metric epilogue src/metrics.rs:258-365,
per-row quickselect src/topk.rs:6-75) with one traceable program that
never holds the whole (n_queries, n_corpus) score matrix.  A
``lax.fori_loop`` walks the prepared corpus in slabs of rows; each step

1. takes one slab: a contiguous row range, or for probed search the
   tiles each query block lists, gathered;
2. dequantizes it inside the step (int8 codes and int4 nibbles are exact
   in bf16);
3. takes the product at the tier's named precision (``_step_products``);
4. applies the epilogue: the per-row scale of the quantized tiers, the
   additive bias (euclidean ``-|c|^2`` and ``-inf`` on dead rows), and
   the row mask by select;
5. merges the step's own top-k into the running (m, k) carry with
   ``lax.top_k`` over ``[carry | step]``.

Only one step's score slab exists at a time; the step height is chosen
from the batch size so that slab stays bounded (``step_rows``).

Metric handling (every metric is a dot product plus one bias):
  dot:       s = q . c
  cosine:    q and c are pre-scaled by their inverse norms (zero-norm rows
             by 0, so their scores are exactly 0.0, matching reference
             metrics.rs:275-289), so s = q' . c'
  euclidean: s = 2 q.c - |c|^2, which ranks like -|q - c|^2; the per-query
             |q|^2 and the monotonic sqrt are applied once to the final
             (m, k) values (reference metrics.rs:302-307 up to rounding).

Contract: values best-first; ties broken lowest-corpus-index first
(``lax.top_k`` keeps the lower position on ties, the carry only holds
rows from earlier steps, and a step's columns are in corpus order — probed
tile lists are ascending); slots no live row can fill carry the
``(-inf, int32-max)`` sentinels (``+inf`` distance after the euclidean
finalize).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SearchConfig, resolve
from ..ops.metrics import Metric, cosine_eps
from ..ops import reference

_NEG_INF = float("-inf")
_BIG_I32 = int(np.iinfo(np.int32).max)

# Every product names its arithmetic.  An f32 dot left at the default
# precision runs in TF32 on the GPU, which misses the score contract, so
# f32 operands always go at HIGHEST; DEFAULT is named only on bf16
# operands, whose products are exact in f32.
_F32 = jax.lax.Precision.HIGHEST
_BF16 = jax.lax.Precision.DEFAULT

# Tiers whose queries arrive as a bf16 hi|lo pair.
_SPLIT_QUERY_TIERS = ("bf16x3", "bf16c", "int8c", "int4c")

# Step sizing: one step's (m, S) f32 score slab and its dequantized
# (S, dim) corpus slab stay under these, so the product is a large GEMM
# while the transient memory is bounded whatever the corpus size.
_SCORE_SLAB_BYTES = 64 << 20
_CORPUS_SLAB_BYTES = 256 << 20
_MIN_STEP_ROWS = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_K_CHUNK = 2048


def feature_chunk(dim: int) -> int:
    """Feature-axis chunk width of the int4 packing layout.

    Features are padded to a multiple of 128; widths up to 4096 pack as
    one chunk, wider ones in 2048-wide chunks.  Saved int4 corpora carry
    this layout, so it is fixed.
    """
    dp = _round_up(dim, 128)
    return dp if dp <= 4096 else _K_CHUNK


def feature_geometry(dim: int):
    """(ck, dpp, nk): chunk width, padded feature width, chunk count."""
    ck = feature_chunk(dim)
    dpp = _round_up(_round_up(dim, 128), ck)
    return ck, dpp, dpp // ck


def pad_mask_row(mask, width: int):
    """(n,) bool mask -> (width,) with the padded tail excluded."""
    mask = jnp.asarray(mask).astype(bool).reshape(-1)
    return jnp.pad(mask, (0, width - mask.shape[0]), constant_values=False)


def _unpack_int4_i32(p32):
    """Sign-extended nibble pair from an int32-widened packed byte."""
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = (((p32 >> 4) & 0xF) ^ 8) - 8
    return lo, hi


def _int4_codes(packed, dpp: int):
    """(..., dpp // 2) packed bytes -> (..., dpp) int32 codes in feature
    order (the single inverse of quantize_int4's layout)."""
    ck, dpp, nk = feature_geometry(dpp)
    lead = packed.shape[:-1]
    p32 = packed.astype(jnp.int32).reshape(*lead, nk, ck // 2)
    lo, hi = _unpack_int4_i32(p32)
    return jnp.concatenate([lo, hi], axis=-1).reshape(*lead, dpp)


def dequant_int4(packed: jax.Array, scales: jax.Array, dim: int):
    """Dense f32 rows from nibble-packed codes."""
    _, dpp, _ = feature_geometry(dim)
    codes = _int4_codes(packed, dpp)[:, :dim]
    return codes.astype(jnp.float32) * scales[:, None]


def quantize_int4(c: jax.Array, ck: int):
    """Per-row symmetric int4 quantization, nibble-packed per chunk.

    Packing layout (per ck-wide feature chunk): byte j holds feature j in
    its LOW nibble and feature j + ck/2 in its HIGH nibble, so unpacking
    is two shifts and one concat, and features come back in order.
    Codes are in [-7, 7] (the -8 slot unused, symmetric);
    row ~= codes * scale with scale = max|row| / 7.
    Returns (packed (n, dpp//2) int8, scales (n,) f32).
    """
    c = c.astype(jnp.float32)
    n, dim = c.shape
    dpp = _round_up(_round_up(dim, 128), ck)
    amax = jnp.max(jnp.abs(c), axis=1, keepdims=True)
    scale = jnp.where(amax > 0, amax / 7.0, 1.0)
    codes = jnp.clip(jnp.rint(c / scale), -7, 7).astype(jnp.int32)
    codes = jnp.pad(codes, ((0, 0), (0, dpp - dim)))
    nk = dpp // ck
    ch = codes.reshape(n, nk, ck)
    lo = ch[:, :, : ck // 2]
    hi = ch[:, :, ck // 2:]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(jnp.int8)
    return packed.reshape(n, dpp // 2), scale[:, 0]


def _quant_bias(code_sumsq, scales, metric, n_valid,
                eps: float = 0.0) -> jax.Array:
    """(2, rows) scale|bias epilogue operand of a quantized corpus.

    For cosine the dequant scale cancels against the row norm, so the
    scale row is the inverse code norm (0 at norm <= ``eps``); rows >=
    ``n_valid`` (capacity reserve and padding, all zero) get a -inf bias.
    """
    metric = Metric.parse(metric)
    rows = code_sumsq.shape[0]
    code_norm = jnp.sqrt(code_sumsq)
    if metric is Metric.COSINE:
        cs = jnp.where(code_norm > eps, 1.0 / code_norm, 0.0)
        cb = jnp.zeros((rows,), jnp.float32)
    elif metric is Metric.EUCLIDEAN:
        cs = scales.astype(jnp.float32)
        cb = -(cs * code_norm) ** 2
    else:
        cs = scales.astype(jnp.float32)
        cb = jnp.zeros((rows,), jnp.float32)
    live = jnp.arange(rows) < n_valid
    cb = jnp.where(live, cb, -np.inf)
    return jnp.stack([cs, cb], axis=0).astype(jnp.float32)


def prepare_int4_bias(packed: jax.Array, scales: jax.Array, metric,
                      n_valid) -> jax.Array:
    """The (2, rows) scale|bias operand for an int4 corpus whose packed
    buffer is used as the prepared corpus as is.  Norms come straight
    from the nibbles (feature order does not matter to a sum of
    squares).  Pure and traceable; ``n_valid`` may be traced."""
    lo, hi = _unpack_int4_i32(packed.astype(jnp.int32))
    sumsq = jnp.sum((lo * lo + hi * hi).astype(jnp.float32), axis=1)
    return _quant_bias(sumsq, scales, metric, n_valid)


def quantize_int8(c: jax.Array):
    """Per-row symmetric int8 quantization: codes * scale[:, None] ~= c.

    Zero rows get scale 1.0 so the dequantized row is exactly zero and no
    division blows up.  rint ties-to-even matches np.rint on the host path.
    """
    c = c.astype(jnp.float32)
    amax = jnp.max(jnp.abs(c), axis=1, keepdims=True)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    codes = jnp.rint(c / scale).astype(jnp.int8)
    return codes, scale[:, 0]


def prepare_int8_bias(codes: jax.Array, scales: jax.Array, metric,
                      n_valid) -> jax.Array:
    """The (2, rows) scale|bias operand for an int8 corpus whose code
    buffer is used as the prepared corpus as is (quantized prep never
    changes the codes, so the buffer is shared, not copied).  Pure and
    traceable; ``n_valid`` may be traced."""
    codesf = codes.astype(jnp.float32)
    return _quant_bias(jnp.sum(codesf * codesf, axis=1), scales, metric,
                       n_valid)


def _split_hi_lo(x):
    """f32 -> (hi, lo) bf16 with hi + lo == x to ~2^-16 relative.

    hi is built by integer bit-masking, not x.astype(bf16) round-tripped
    to f32: an excess-precision simplification may fold that convert pair
    and leave lo == 0.  +0x8000 & mask rounds to nearest in IEEE bit
    space (the carry propagates into the exponent correctly).
    """
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        (bits + jnp.uint32(0x8000)) & jnp.uint32(0xFFFF0000),
        jnp.float32,
    )
    lo = x - hi  # exact; its significand is <= 8 bits -> bf16-exact
    return hi.astype(jnp.bfloat16), lo.astype(jnp.bfloat16)


def prepare_corpus(c: jax.Array, metric, *, precision: str,
                   scales: "Optional[jax.Array]" = None):
    """Metric pre-scaling and storage conversion of the corpus.

    Pure and traceable; the Corpus handle jits this once and keeps the
    result on device so steady-state queries do no per-call corpus work.
    Returns (cp, cbp): the prepared corpus and its epilogue operand —
    (1, n) additive bias, or (2, n) scale|bias for the storage tiers.

    ``precision="int8c"``: ``c`` is f32 (quantized here) or int8 codes
    with ``scales`` (n,) from quantize_int8.  ``"int4c"``: f32, or packed
    codes with ``scales``.  ``"bf16c"``: the bf16 values.  The stored
    values are returned unchanged as cp (cosine's inverse norm rides the
    scale row, so nothing is quantized twice).
    """
    metric = Metric.parse(metric)
    n, dim = c.shape
    if precision == "int4c":
        if c.dtype != jnp.int8:
            ck, _, _ = feature_geometry(dim)
            c, scales = quantize_int4(c, ck)
        return c, prepare_int4_bias(c, scales, metric, n)
    if precision == "int8c":
        if c.dtype != jnp.int8:
            c, scales = quantize_int8(c)
        return c, prepare_int8_bias(c, scales, metric, n)
    if precision == "bf16c":
        # The barrier pins the rounding to bf16: XLA may otherwise drop an
        # f32 -> bf16 convert (excess precision) and run the product on
        # the unrounded f32 rows at the default precision, i.e. in TF32.
        c = jax.lax.optimization_barrier(c.astype(jnp.bfloat16))
        cf = c.astype(jnp.float32)
        return c, _quant_bias(jnp.sum(cf * cf, axis=1),
                              jnp.ones((n,), jnp.float32), metric, n,
                              eps=cosine_eps(jnp.float32))
    c = c.astype(jnp.float32)
    if metric is Metric.COSINE:
        eps = cosine_eps(jnp.float32)
        cn = jnp.sqrt(jnp.sum(c * c, axis=1, keepdims=True))
        c = c * jnp.where(cn > eps, 1.0 / cn, 0.0)
        cb = jnp.zeros((1, n), jnp.float32)
    elif metric is Metric.EUCLIDEAN:
        cb = -jnp.sum(c * c, axis=1).reshape(1, n)
    else:
        cb = jnp.zeros((1, n), jnp.float32)
    if precision == "bf16x3":
        c = jnp.concatenate(_split_hi_lo(c), axis=1)  # [hi | lo]
    return c, cb


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------


def _corpus_width(cp, precision: str) -> int:
    """Logical feature width the prepared corpus multiplies against."""
    if precision == "int4c":
        return 2 * cp.shape[1]
    if precision == "bf16x3":
        return cp.shape[1] // 2
    return cp.shape[1]


def _prepare_queries(q, metric: Metric, precision: str, width: int):
    """Metric scaling, feature padding and (split tiers) hi|lo split."""
    q = q.astype(jnp.float32)
    if metric is Metric.COSINE:
        eps = cosine_eps(jnp.float32)
        qn = jnp.sqrt(jnp.sum(q * q, axis=1, keepdims=True))
        q = q * jnp.where(qn > eps, 1.0 / qn, 0.0)
    elif metric is Metric.EUCLIDEAN:
        q = 2.0 * q
    q = jnp.pad(q, ((0, 0), (0, width - q.shape[1])))
    if precision in _SPLIT_QUERY_TIERS:
        return _split_hi_lo(q)
    return (q,)


def _bdot(a, b, precision):
    """(B, m, d) x (B, S, d) -> (B, m, S) f32."""
    return jax.lax.dot_general(
        a, b,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        precision=precision,
        preferred_element_type=jnp.float32,
    )


def _step_products(qs, slab, precision: str):
    """Raw products (B, m, S) of the prepared queries with one slab.

    highest: f32 at full precision.  bf16x3: three bf16 products over the
    stored hi|lo corpus split (hi.hi + hi.lo + lo.hi; the dropped lo.lo
    term is ~2^-16 relative).  bf16c/int8c/int4c: the hi|lo query pair
    against the bf16-exact corpus values, two bf16 products; the per-row
    scale is applied by the epilogue.  All accumulate in f32.
    """
    if precision == "highest":
        return _bdot(qs[0], slab, _F32)
    if precision == "bf16x3":
        qh, ql = qs
        w = qh.shape[-1]
        ch, cl = slab[..., :w], slab[..., w:]
        return (_bdot(qh, ch, _BF16)
                + (_bdot(qh, cl, _BF16) + _bdot(ql, ch, _BF16)))
    if precision == "int4c":
        c = _int4_codes(slab, 2 * slab.shape[-1]).astype(jnp.bfloat16)
    elif precision == "int8c":
        # The barrier keeps XLA from fusing the int8 -> bf16 convert into
        # the GEMM: that mixed-type GEMM returned garbage rows (1e34, NaN)
        # on an H100 at 256-query batches, while the same product over a
        # materialized bf16 slab is exact.
        c = jax.lax.optimization_barrier(slab.astype(jnp.bfloat16))
    else:
        c = slab
    qh, ql = qs
    return _bdot(qh, c, _BF16) + _bdot(ql, c, _BF16)


def _step_scores(qs, slab, cb, mk, precision: str):
    """Epilogue over one step: (B, m, S) maximize-orientation scores.

    ``cb`` (rows, B, S) is the bias, or scale|bias for quantized tiers;
    ``mk`` (B, S) bool or None.  The mask filters by select, not by
    arithmetic, so a NaN product on an excluded row cannot leak.
    """
    d = _step_products(qs, slab, precision)
    if cb.shape[0] == 2:
        s = d * cb[0][:, None, :] + cb[1][:, None, :]
    else:
        s = d + cb[0][:, None, :]
    if mk is not None:
        s = jnp.where(mk[:, None, :], s, _NEG_INF)
    return s


def _merge(carry, s, cols_of):
    """Merge one step into the running (B, m, k) carry.

    ``cols_of(pos)`` maps step column positions to corpus row ids.  The
    carry goes first in the concatenation, so a tie keeps the earlier
    (lower-index) row.
    """
    vals, idx = carry
    k = vals.shape[-1]
    sv, sp = jax.lax.top_k(s, min(k, s.shape[-1]))
    si = cols_of(sp)
    v, p = jax.lax.top_k(jnp.concatenate([vals, sv], axis=-1), k)
    i = jnp.take_along_axis(jnp.concatenate([idx, si], axis=-1), p, axis=-1)
    return v, i


def _init_carry(b: int, m: int, k: int):
    return (jnp.full((b, m, k), _NEG_INF, jnp.float32),
            jnp.full((b, m, k), _BIG_I32, jnp.int32))


def step_rows(m: int, width: int, precision: str) -> int:
    """Corpus rows per scan step for an m-query batch: the largest power
    of two that keeps the (m, S) score slab and the dequantized (S, width)
    corpus slab within their budgets, and never below 1024 rows."""
    row_bytes = width * (4 if precision in ("highest", "bf16x3") else 2)
    s = min(_SCORE_SLAB_BYTES // (4 * max(m, 1)),
            _CORPUS_SLAB_BYTES // max(row_bytes, 1))
    s = max(s, _MIN_STEP_ROWS)
    return 1 << (s.bit_length() - 1)


def _triton_step(carry, qs, slab, bias, r0):
    """The step through ``triton_step`` (bf16x3, k <= 16, on a GPU): the
    kernel keeps the score tile in registers and hands XLA each corpus
    block's best candidates to merge."""
    from . import triton_step

    qh, ql = qs[0][0], qs[1][0]
    m = qh.shape[0]
    bq = min(64, max(16, 1 << (m - 1).bit_length()))
    pad = (-slab.shape[0]) % triton_step.BLOCK_N
    if pad:
        slab = jnp.pad(slab, ((0, pad), (0, 0)))
        bias = jnp.pad(bias, (0, pad), constant_values=_NEG_INF)
    mp = _round_up(m, bq)
    qh = jnp.pad(qh, ((0, mp - m), (0, 0)))
    ql = jnp.pad(ql, ((0, mp - m), (0, 0)))
    v, i = triton_step.step_candidates(qh, ql, slab, bias,
                                       k=carry[0].shape[-1], bq=bq)
    return _merge(carry, v[None, :m], lambda p: jnp.take_along_axis(
        i[None, :m], p, axis=-1) + r0)


def _scan_dense(qs, cp, cbp, mk, k: int, step: int, precision: str):
    """Dense scan: every corpus row, in contiguous steps of ``step``.

    At k <= 16 on the bf16x3 tier (feature width a multiple of 64) the
    step lowers to the Triton kernel on a GPU (measured faster than XLA's
    product + ``lax.top_k`` there) and to the XLA step everywhere else."""
    from .triton_step import BLOCK_K, KP

    rows = cp.shape[0]
    n_full, tail = divmod(rows, step)

    def run(r0, size, carry):
        slab = jax.lax.dynamic_slice_in_dim(cp, r0, size, 0)
        cb = jax.lax.dynamic_slice_in_dim(cbp, r0, size, 1)
        m_s = (None if mk is None else
               jax.lax.dynamic_slice_in_dim(mk, r0, size, 0))

        def xla(carry):
            s = _step_scores(qs, slab[None], cb[:, None, :],
                             None if m_s is None else m_s[None], precision)
            return _merge(carry, s, lambda p: p + r0)

        if precision != "bf16x3" or k > KP or qs[0].shape[-1] % BLOCK_K:
            return xla(carry)
        bias = cb[0] if m_s is None else jnp.where(m_s, cb[0], _NEG_INF)
        return jax.lax.platform_dependent(
            carry, cuda=lambda c: _triton_step(c, qs, slab, bias, r0),
            default=xla)

    carry = _init_carry(1, qs[0].shape[1], k)
    if n_full:
        carry = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(n_full),
            lambda j, c: run(j * jnp.int32(step), step, c), carry)
    if tail:
        carry = run(jnp.int32(n_full * step), tail, carry)
    return carry


def _scan_probed(qs, cp, cbp, mk, tiles, k: int, tn: int, g: int,
                 precision: str):
    """Probed scan: query block b visits only the corpus tiles listed in
    ``tiles[b]`` (ascending, distinct), ``g`` listed tiles per step,
    gathered from the tile-shaped view of the prepared corpus."""
    qb, p = tiles.shape
    n_tiles = cp.shape[0] // tn
    cp3 = cp.reshape(n_tiles, tn, cp.shape[1])
    cb3 = cbp.reshape(cbp.shape[0], n_tiles, tn)
    mk3 = None if mk is None else mk.reshape(n_tiles, tn)
    lane = jnp.arange(tn, dtype=jnp.int32)
    n_full, tail = divmod(p, g)

    def run(t, carry):
        gt = t.shape[1]
        slab = cp3[t].reshape(qb, gt * tn, cp.shape[1])
        cb = cb3[:, t].reshape(cbp.shape[0], qb, gt * tn)
        m_s = None if mk3 is None else mk3[t].reshape(qb, gt * tn)
        s = _step_scores(qs, slab, cb, m_s, precision)
        cols = (t[:, :, None] * tn + lane).reshape(qb, gt * tn)
        return _merge(carry, s, lambda pos: jnp.take_along_axis(
            cols[:, None, :], pos, axis=-1))

    carry = _init_carry(qb, qs[0].shape[1], k)
    if n_full:
        carry = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(n_full),
            lambda j, c: run(jax.lax.dynamic_slice_in_dim(
                tiles, j * jnp.int32(g), g, 1), c), carry)
    if tail:
        carry = run(tiles[:, n_full * g:], carry)
    return carry


def query_block_rows(m: int, cfg: SearchConfig) -> int:
    """Query rows per probe block for an m-query batch; a tile list has
    one row per block (n_blocks = ceil(m / this))."""
    return min(cfg.block_q, _round_up(m, 8))


def _search(q, cp, cbp, mk, tiles, *, k: int, metric: Metric,
            precision: str, tn: int, tm: int,
            step: Optional[int]) -> Tuple[jax.Array, jax.Array]:
    """Query prep + scan + euclidean finalize against a prepared corpus."""
    m = q.shape[0]
    width = _corpus_width(cp, precision)
    qs = _prepare_queries(q, metric, precision, width)
    if tiles is None:
        st = step or step_rows(m, width, precision)
        qs = tuple(x[None] for x in qs)
        vals, idx = _scan_dense(qs, cp, cbp, mk, k, st, precision)
        vals, idx = vals[0], idx[0]
    else:
        pad = (-cp.shape[0]) % tn
        if pad:  # the tile view needs whole tiles; pad rows are dead
            cp = jnp.pad(cp, ((0, pad), (0, 0)))
            cbp = jnp.concatenate([
                jnp.pad(cbp[:-1], ((0, 0), (0, pad))),
                jnp.pad(cbp[-1:], ((0, 0), (0, pad)),
                        constant_values=_NEG_INF)], axis=0)
            if mk is not None:
                mk = jnp.pad(mk, (0, pad), constant_values=False)
        qb = tiles.shape[0]
        qs = tuple(
            jnp.pad(x, ((0, qb * tm - m), (0, 0))).reshape(qb, tm, width)
            for x in qs)
        st = step or step_rows(tm * qb, width, precision)
        g = max(1, min(tiles.shape[1], st // tn))
        vals, idx = _scan_probed(qs, cp, cbp, mk, tiles.astype(jnp.int32),
                                 k, tn, g, precision)
        vals = vals.reshape(qb * tm, k)[:m]
        idx = idx.reshape(qb * tm, k)[:m]
    idx = jnp.where(vals == _NEG_INF, jnp.int32(_BIG_I32), idx)
    if metric is Metric.EUCLIDEAN:
        qf = q.astype(jnp.float32)
        qsq = jnp.sum(qf * qf, axis=1, keepdims=True)
        vals = jnp.sqrt(jnp.maximum(qsq - vals, 0.0))
    return vals, idx


def fused_topk_prepared(
    q: jax.Array,
    cp: jax.Array,
    cbp: jax.Array,
    k: int,
    metric,
    *,
    mask: Optional[jax.Array] = None,
    config: Optional[SearchConfig] = None,
    tiles: Optional[jax.Array] = None,
    tn: Optional[int] = None,
    step: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k against a corpus prepared by ``prepare_corpus`` (or a shared
    quantized buffer with its scale|bias operand).  Traceable.

    ``mask`` (n,) bool filters corpus rows.  ``config.precision`` names
    the tier cp was prepared for.

    ``tiles`` (n_query_blocks, P) int32 opts into probed search: query
    block b (``query_block_rows`` rows) scans only its listed tile ids
    (ascending, distinct, each < rows / ``tn``).  Exact over the visited
    rows; recall depends on which tiles are listed (see ops.cluster).
    Slots a query cannot fill from its listed tiles come back as
    (-inf, int32-max) sentinels.

    ``step`` overrides the rows per scan step (``step_rows``).
    """
    cfg = resolve(config)
    metric = Metric.parse(metric)
    rows = cbp.shape[1]
    mk = None if mask is None else pad_mask_row(mask, rows)
    tn = cfg.block_n if tn is None else tn
    tm = query_block_rows(q.shape[0], cfg)
    if tiles is not None:
        n_tiles = -(-rows // tn)
        if tiles.shape[1] > n_tiles:
            raise ValueError(
                f"tiles lists {tiles.shape[1]} tiles per query block; the "
                f"prepared corpus only has {n_tiles} (repeating a tile "
                "would duplicate its rows in the result)"
            )
        if tiles.shape[0] != -(-q.shape[0] // tm):
            raise ValueError(
                f"tiles has {tiles.shape[0]} rows; this problem runs "
                f"{-(-q.shape[0] // tm)} query blocks of {tm} rows"
            )
    return _search(q, cp, cbp, mk, tiles, k=k, metric=metric,
                   precision=cfg.precision, tn=tn, tm=tm, step=step)


@functools.partial(jax.jit,
                   static_argnames=("k", "metric", "precision", "step"))
def _oneshot(q, c, mask, *, k: int, metric: Metric, precision: str,
             step: Optional[int]):
    cp, cbp = prepare_corpus(c, metric, precision=precision)
    mk = None if mask is None else pad_mask_row(mask, cbp.shape[1])
    return _search(q, cp, cbp, mk, None, k=k, metric=metric,
                   precision=precision, tn=1, tm=1, step=step)


def fused_topk(
    q: jax.Array,
    c: jax.Array,
    k: int,
    metric=Metric.COSINE,
    *,
    mask: Optional[jax.Array] = None,
    config: Optional[SearchConfig] = None,
    step: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k search. Returns ((m, k) scores best-first, (m, k) indices).

    ``k`` must already be clamped to ``c.shape[0]``.  ``mask`` (n_corpus,)
    bool excludes corpus rows (filtered search); slots beyond the number
    of matching rows carry sentinel scores (-inf similarity / +inf
    distance) and int32-max indices.  f64 inputs take the dense f64
    reference path.
    """
    cfg = resolve(config)
    metric = Metric.parse(metric)
    mk = None if mask is None else jnp.asarray(mask).astype(bool)
    if q.dtype != jnp.float32 or c.dtype != jnp.float32:
        return reference.topk_search(q, c, k, metric, mask=mk)
    return _oneshot(q, c, mk, k=k, metric=metric, precision=cfg.precision,
                    step=step)
