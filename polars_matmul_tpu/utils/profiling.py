"""Tracing / profiling helpers (SURVEY.md §5: absent in the reference).

- ``annotate``: jax.profiler trace annotation around extract / transfer /
  compute / merge phases; no-op outside an active trace.
- ``call_stats``: structured per-call stats behind a debug flag
  (PMM_TPU_DEBUG=1), on the standard ``logging`` logger.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

log = logging.getLogger("polars_matmul_tpu")
_DEBUG = os.environ.get("PMM_TPU_DEBUG", "0") == "1"


@contextlib.contextmanager
def annotate(name: str):
    """Profiler trace annotation + optional debug timing."""
    try:
        import jax.profiler

        ctx = jax.profiler.TraceAnnotation(name)
    except Exception:  # pragma: no cover
        ctx = contextlib.nullcontext()
    t0 = time.perf_counter() if _DEBUG else 0.0
    with ctx:
        yield
    if _DEBUG:
        log.info("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


def call_stats(op: str, *, m: int, n: int, dim: int, k: Optional[int] = None,
               dtype=None, wall_s: Optional[float] = None) -> None:
    """Structured per-call stats on the package logger (PMM_TPU_DEBUG=1).

    One JSON line per call: shapes, dtype, host->device / device->host
    bytes, wall time and achieved GFLOP/s (wall-clock; includes transfers).
    """
    if not _DEBUG:
        return
    import json

    itemsize = 4 if str(dtype) == "float32" else 8
    rec = {
        "op": op,
        "m": m,
        "n": n,
        "dim": dim,
        "dtype": str(dtype),
        "bytes_h2d": m * dim * itemsize,
        # top-k results come back packed as (m, 2k) of the compute width
        "bytes_d2h": (m * k * 2 * itemsize if k is not None
                      else m * n * itemsize),
    }
    if k is not None:
        rec["k"] = k
    if wall_s:
        rec["wall_ms"] = round(wall_s * 1e3, 3)
        rec["wall_gflops"] = round(2.0 * m * n * dim / wall_s / 1e9, 1)
    log.info(json.dumps(rec))
