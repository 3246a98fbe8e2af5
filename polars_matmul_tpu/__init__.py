"""polars-matmul-tpu: accelerator similarity search for Polars/Arrow.

A from-scratch JAX/XLA rebuild of the capabilities of ``polars-matmul``
(the Rust/faer Polars plugin; structural analysis in SURVEY.md): dense
query x corpus ``matmul`` and ``topk`` similarity search (cosine / dot /
euclidean) as Polars expressions, plus what the reference never had — a
top-k scan that never materializes the full score matrix, quantized
storage tiers, a device-resident ``Corpus`` handle, clustered probed
search, and the corpus sharded across a device mesh.

Importing needs only JAX and NumPy.  The ``.pmm`` namespace is registered
on ``pl.Expr`` when polars is installed (same side-effect-on-import UX as
the reference, SURVEY.md §3.4); the Arrow functions (``topk_arrow``/
``matmul_arrow``) need pyarrow and import it when called; the NumPy
(``topk``/``matmul``/``Corpus``) APIs need neither.
"""

from __future__ import annotations

from . import config as _config

__version__ = "0.1.0"

# The f64 compute path (both-f32 rule) needs 64-bit mode; enable before any
# jax arrays exist.  Opt out with PMM_TPU_DISABLE_X64=1.
_config.ensure_x64()

from .config import SearchConfig, default_config, set_default_config  # noqa: E402
from .ops.metrics import Metric  # noqa: E402
from .api.search import Corpus, matmul, topk  # noqa: E402
from .api.clustered import ClusteredCorpus  # noqa: E402
# Traceable device-level ops: jax arrays in, jax arrays out, fully
# jittable — compose search into larger jit programs (e.g. an embedding
# model's output feeding straight into top-k with no host round-trip).
# topk_jax returns ((m, k) f32 scores best-first, (m, k) i32 indices).
from .kernels.fused_topk import fused_topk as topk_jax  # noqa: E402
from .kernels.matmul import pairwise_matmul as matmul_jax  # noqa: E402
from .api.arrow_ops import matmul_arrow, topk_arrow  # noqa: E402
from .parallel.mesh import init_distributed, make_mesh  # noqa: E402
from .parallel.sharded import (  # noqa: E402
    ShardedCorpus,
    distributed_matmul,
    distributed_topk,
    shard_corpus,
)

__all__ = [
    "ClusteredCorpus",
    "Corpus",
    "Metric",
    "SearchConfig",
    "ShardedCorpus",
    "default_config",
    "distributed_matmul",
    "distributed_topk",
    "init_distributed",
    "make_mesh",
    "matmul",
    "matmul_arrow",
    "matmul_jax",
    "set_default_config",
    "shard_corpus",
    "topk",
    "topk_arrow",
    "topk_jax",
]

# Register the Polars .pmm expression namespace when polars is available.
try:  # pragma: no cover - depends on environment
    import polars  # noqa: F401

    _HAS_POLARS = True
except Exception:  # ModuleNotFoundError and any polars-internal failure
    _HAS_POLARS = False

if _HAS_POLARS:
    from .api.namespace import PmmNamespace  # noqa: F401

    __all__.append("PmmNamespace")
