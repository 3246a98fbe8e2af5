"""Pairwise matmul (Q . C^T).

The reference's raw-matmul op (src/metrics.rs:40-255) is a single XLA
``dot_general``; XLA hands it to the GPU's GEMM library.  It always
computes at full precision of its dtype: an f32 product left at the
default precision would run in TF32 on the GPU.
"""

from __future__ import annotations

import jax


@jax.jit
def pairwise_matmul(q: jax.Array, c: jax.Array) -> jax.Array:
    """Q . C^T at full f32 / f64 precision."""
    return jax.lax.dot_general(
        q,
        c,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=q.dtype,
    )
