"""One scan step as a Pallas kernel through Triton (``backend="triton"``).

For k <= 16 on the bf16x3 hi|lo corpus: each program takes a
(block_q, block_n) tile of queries x corpus rows, accumulates the three
bf16 products (hi.hi + hi.lo + lo.hi) in f32 over the feature axis, adds
the bias row, and runs k max-extractions in registers.  It writes the
tile's (block_q, 16) best (value, row) candidates; XLA merges them.  The
score tile never reaches device memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

KP = 16        # candidate slots per tile (power of two, >= k)
BLOCK_N = 128  # corpus rows per tile
BLOCK_K = 64   # feature columns per product (the width must divide)
_BIG = jnp.iinfo(jnp.int32).max
_NEG_INF = float("-inf")


def _dot(a, b):
    """(bq, bk) x (bn, bk) bf16 -> (bq, bn) f32."""
    return pl.dot(a, b, trans_b=True, precision=jax.lax.Precision.DEFAULT)


def _kernel(qh_ref, ql_ref, c_ref, b_ref, v_ref, i_ref, *, bq, bn, bk, d,
            k):
    qi = pl.program_id(0)
    cj = pl.program_id(1)
    rq = pl.ds(qi * bq, bq)
    rc = pl.ds(cj * bn, bn)

    def body(t, acc):
        k0 = pl.multiple_of(t * bk, bk)
        qh = qh_ref[rq, pl.ds(k0, bk)]
        ql = ql_ref[rq, pl.ds(k0, bk)]
        ch = c_ref[rc, pl.ds(k0, bk)]
        cl = c_ref[rc, pl.ds(d + k0, bk)]
        return acc + (_dot(qh, ch) + _dot(qh, cl) + _dot(ql, ch))

    acc = jax.lax.fori_loop(0, d // bk, body,
                            jnp.zeros((bq, bn), jnp.float32))
    b = b_ref[rc][None, :]
    # dead or masked rows (-inf bias) by select: a NaN product there
    # must not reach the max
    s = jnp.where(b == _NEG_INF, _NEG_INF, acc + b)
    col = cj * bn + jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, KP), 1)
    vals = jnp.full((bq, KP), -jnp.inf, jnp.float32)
    idx = jnp.full((bq, KP), _BIG, jnp.int32)
    for t in range(k):
        m = jnp.max(s, axis=1)
        a = jnp.min(jnp.where(s == m[:, None], col, _BIG), axis=1)
        vals = jnp.where(lane == t, m[:, None], vals)
        idx = jnp.where(lane == t, a[:, None], idx)
        s = jnp.where(col == a[:, None], -jnp.inf, s)
    v_ref[cj, rq, :] = vals
    i_ref[cj, rq, :] = idx


@functools.partial(jax.jit, static_argnames=("k", "bq", "bn", "bk",
                                             "interpret"))
def step_candidates(qh, ql, slab, bias, *, k: int, bq: int = 64,
                    bn: int = BLOCK_N, bk: int = BLOCK_K,
                    interpret: bool = False):
    """(m, nb * 16) candidate (values, rows) of one corpus slab.

    ``qh``/``ql`` (m, d) bf16 with m % bq == 0 and d % bk == 0; ``slab``
    (S, 2d) bf16 [hi | lo] with S % bn == 0; ``bias`` (S,) f32, -inf on
    dead or masked rows.  Row ids are slab positions.  ``interpret`` runs
    the kernel in the Pallas interpreter (tests on a CPU).
    """
    m, d = qh.shape
    s_rows = slab.shape[0]
    nb = s_rows // bn
    kern = functools.partial(_kernel, bq=bq, bn=bn, bk=bk, d=d, k=k)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    v, i = pl.pallas_call(
        kern,
        grid=(m // bq, nb),
        in_specs=[any_spec] * 4,
        out_specs=[any_spec, any_spec],
        out_shape=[jax.ShapeDtypeStruct((nb, m, KP), jnp.float32),
                   jax.ShapeDtypeStruct((nb, m, KP), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="pmt_triton_step",
    )(qh, ql, slab, bias)
    v = jnp.transpose(v, (1, 0, 2)).reshape(m, nb * KP)
    i = jnp.transpose(i, (1, 0, 2)).reshape(m, nb * KP)
    return v, i
