"""Test harness config: CPU backend with 8 virtual devices.

Must run before jax is imported anywhere (SURVEY.md §4 multi-device-without-
cluster strategy): the full API contract runs on CPU and sharding tests run
on a fake 8-device mesh.  Tests marked ``gpu`` need the card and skip here
(``chip_smoke.py`` runs them on it).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches_between_modules():
    """Clear jax's compilation caches at each module boundary.

    The full suite compiles thousands of distinct executables on the
    8-virtual-device CPU backend; letting them accumulate in one process
    ended in a segfault inside XLA:CPU's compiler (~test #340 of 378,
    reproducibly, in whatever test happened to compile next — round 4).
    Per-module clearing bounds the live-executable count; recompiles
    within a module still amortize."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none.  Decided
    here, at run time, never at import or collection."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def qc_f32():
    """Shared medium problem reused across tests to amortize jit compiles.

    Uses its own seeded rng: drawing from the shared session rng would make
    the data depend on test execution order."""
    r = np.random.default_rng(1234)
    q = r.standard_normal((37, 56)).astype(np.float32)
    c = r.standard_normal((203, 56)).astype(np.float32)
    return q, c


@pytest.fixture(scope="session")
def qc_f64(qc_f32):
    q, c = qc_f32
    return q.astype(np.float64), c.astype(np.float64)


def assert_topk_equivalent(idx_a, val_a, idx_b, val_b, rtol=2e-5, atol=8e-6):
    """Top-k results equal, tolerating swaps among numerically-tied scores.

    Tolerances cover the default bf16x3 precision tier: its score error
    is the dropped lo.lo cross term, ~2^-18 per product accumulated over
    dim (~1e-5 relative worst-case, ~3e-6 absolute on unit-scale scores) —
    irrelevant next to embedding noise but above f32 roundoff.
    """
    np.testing.assert_allclose(val_a, val_b, rtol=rtol, atol=atol)
    mism = idx_a != idx_b
    if mism.any():
        # Any index mismatch must be between entries whose scores tie.
        rows, cols = np.nonzero(mism)
        for r, c_ in zip(rows, cols):
            assert abs(val_a[r, c_] - val_b[r, c_]) <= (
                atol + rtol * abs(val_b[r, c_])
            ), f"index mismatch at ({r},{c_}) without score tie"
