"""Global configuration for polars-matmul-tpu.

The reference library (the polars-matmul Rust plugin) is zero-config:
behaviour is fully determined by the call signature
(``topk(corpus, k, metric="cosine")`` — reference ``__init__.py:63-68`` —
and ``matmul(corpus, flatten=False)`` — reference ``__init__.py:121-125``).
We keep that contract: every knob here has a compiled default that preserves
reference semantics, and ``SearchConfig`` is an *optional* override for the
precision tier, the probe geometry, the mesh and the merge strategy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# x64: the reference computes in f64 whenever either input is f64
# (both-f32 rule, reference matmul.rs:13-19,308).  JAX disables 64-bit by
# default, so the package enables it at import unless explicitly disabled.
# ---------------------------------------------------------------------------

_X64_DISABLED = os.environ.get("PMM_TPU_DISABLE_X64", "0") == "1"


def ensure_x64() -> bool:
    """Enable jax 64-bit mode (needed for the f64 compute path).

    Returns True if x64 is active after the call.
    """
    if _X64_DISABLED:
        return False
    import jax

    try:
        jax.config.update("jax_enable_x64", True)
    except Exception:  # pragma: no cover - config frozen after trace
        pass
    return bool(jax.config.jax_enable_x64)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Optional knobs of the search path.  All sizes are in rows."""

    # Query rows per probe block: probed search ranks corpus tiles once
    # per block of this many queries (ClusteredCorpus, sharded probe).
    block_q: int = 256
    # Corpus rows per tile: the unit a clustered layout pads clusters to
    # and a probe lists (ClusteredCorpus files record it).
    block_n: int = 1024
    # Product precision of the f32 search tiers.  "bf16x3" takes three
    # bf16 passes (hi.hi + hi.lo + lo.hi of each f32 operand split, the
    # lo.lo term dropped): score error ~4e-6 relative on random data and
    # bounded by ~1.5e-5 relative in the adversarial worst case (all
    # per-term errors aligned), slightly outside the reference's
    # rtol=1e-5 in that corner.  "highest" is exact f32.  The dense
    # matmul op and the reference oracle always compute exact f32.
    # Quantized storage tiers pick their own arithmetic ("bf16c",
    # "int8c", "int4c"; see kernels.fused_topk._step_products).
    precision: str = "bf16x3"
    # Distributed merge strategy: "allgather" (gather per-shard k candidates,
    # re-select locally) or "ring" (ppermute carry merge).
    merge: str = "allgather"
    # Corpus preparation (Corpus handle) runs in row chunks once the raw
    # corpus exceeds this many bytes: one-shot prep transiently holds ~3x
    # the corpus (raw + scaled + converted), chunked prep ~2x + one chunk.
    prep_chunk_bytes: int = 1 << 30
    # Ring merge only: number of query chunks pipelined around the ring.
    # Chunk p's ppermute chain has no data dependence on chunk p+1's local
    # search, so XLA's scheduler can overlap the exchange with the next
    # chunk's search.  1 disables pipelining.
    ring_pipeline: int = 2
    # Mesh axis names used by the parallel layer.
    mesh_axes: Tuple[str, str] = ("data", "corpus")

    def __post_init__(self):
        # Fail fast on typo'd enum knobs (merge='tree', ...): each of these
        # silently selected a default behavior before.
        for field, allowed in (
            ("merge", ("allgather", "ring")),
            ("precision", ("highest", "bf16x3", "bf16c", "int8c", "int4c")),
        ):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"Unknown {field}: {v!r} (expected one of {allowed})"
                )

    def with_updates(self, **kw) -> "SearchConfig":
        return dataclasses.replace(self, **kw)


_default_config = SearchConfig()


def default_config() -> SearchConfig:
    return _default_config


def set_default_config(cfg: SearchConfig) -> None:
    global _default_config
    _default_config = cfg


def resolve(cfg: Optional[SearchConfig]) -> SearchConfig:
    return cfg if cfg is not None else _default_config
