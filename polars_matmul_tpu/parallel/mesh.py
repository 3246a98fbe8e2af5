"""Device mesh construction and multi-host runtime init.

The reference has no distributed layer at all (SURVEY.md §2.3: the only
parallelism is Rayon intra-op threading).  Here the distributed backend is
JAX/XLA: ``jax.distributed.initialize`` for the multi-host runtime and a
plain named ``Mesh`` grid whose axes are ``("data", "corpus")`` — queries
shard over ``data``, corpus rows shard over ``corpus``.  XLA compiles the
collectives (to NCCL on GPUs); every GPU of a host reaches every other
over NVLink at the same rate, so the grid follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def init_distributed(**kwargs) -> None:
    """Initialize the JAX multi-host runtime (explicit ``init()`` — the one
    thing that cannot be import-side-effected, SURVEY.md §3.4)."""
    import jax

    jax.distributed.initialize(**kwargs)


def make_mesh(
    n_data: int = 1,
    n_corpus: Optional[int] = None,
    *,
    axis_names: Tuple[str, str] = ("data", "corpus"),
    devices: Optional[Sequence] = None,
):
    """Build a (n_data, n_corpus) mesh over the available devices.

    ``n_corpus=None`` uses all remaining devices on the corpus axis.
    """
    import jax
    from jax.sharding import Mesh

    devs = list(devices) if devices is not None else jax.devices()
    if n_corpus is None:
        if len(devs) % n_data != 0:
            raise ValueError(
                f"{len(devs)} devices not divisible by n_data={n_data}"
            )
        n_corpus = len(devs) // n_data
    need = n_data * n_corpus
    if need > len(devs):
        raise ValueError(
            f"Mesh {n_data}x{n_corpus} needs {need} devices, "
            f"have {len(devs)}"
        )
    grid = np.array(devs[:need]).reshape(n_data, n_corpus)
    return Mesh(grid, axis_names)
