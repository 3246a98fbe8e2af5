"""The top-k scan (kernels.fused_topk) against the plain reference.

Contract under test, for every precision tier and for several scan step
heights (one step, many steps with a ragged tail, steps smaller than k):
scores agree with ``ops.reference`` within the tier's tolerance, ties go
to the lowest corpus index, masked and dead rows never appear, unfillable
slots carry the (-inf, int32-max) sentinels (+inf distance after the
euclidean finalize), and probed tile lists restrict the scan exactly.
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polars_matmul_tpu.config import SearchConfig
from polars_matmul_tpu.ops import topk_search

from conftest import assert_topk_equivalent

ft = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

BIG = np.iinfo(np.int32).max
TIERS = ["highest", "bf16x3", "bf16c", "int8c", "int4c"]
METRICS = ["cosine", "dot", "euclidean"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _served_values(c, tier):
    """The corpus values a tier scores against (f32)."""
    c = jnp.asarray(c, jnp.float32)
    if tier == "bf16c":
        return c.astype(jnp.bfloat16).astype(jnp.float32)
    if tier == "int8c":
        codes, scales = ft.quantize_int8(c)
        return codes.astype(jnp.float32) * scales[:, None]
    if tier == "int4c":
        ck, _, _ = ft.feature_geometry(c.shape[1])
        packed, scales = ft.quantize_int4(c, ck)
        return ft.dequant_int4(packed, scales, c.shape[1])
    return c


def _tol(tier):
    # exact tiers: the bf16x3 dropped lo.lo term; storage tiers: the
    # hi|lo query split against bf16-exact values plus the f32 scale
    return (2e-5, 8e-6) if tier in ("highest", "bf16x3") else (1e-4, 2e-5)


def _data(seed, m=11, n=1500, d=40):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, d)).astype(np.float32),
            r.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("step", [None, 256, 700])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("metric", METRICS)
def test_matches_oracle(metric, tier, step):
    q, c = _data(1)
    v, i = ft.fused_topk(jnp.asarray(q), jnp.asarray(c), 17, metric,
                         config=SearchConfig(precision=tier), step=step)
    v0, i0 = topk_search(jnp.asarray(q), _served_values(c, tier), 17,
                         metric)
    rtol, atol = _tol(tier)
    assert_topk_equivalent(np.asarray(i), np.asarray(v), np.asarray(i0),
                           np.asarray(v0), rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [None, 64, 100])
@pytest.mark.parametrize("tier", ["highest", "bf16x3", "int8c"])
def test_ties_lowest_index_first(tier, step):
    # 50 distinct rows repeated 6 times: every score occurs 6 times, so
    # the order among duplicates is the whole test
    r = np.random.default_rng(2)
    base = r.standard_normal((50, 24)).astype(np.float32)
    c = np.tile(base, (6, 1))
    q = r.standard_normal((5, 24)).astype(np.float32)
    v, i = ft.fused_topk(jnp.asarray(q), jnp.asarray(c), 30, "dot",
                         config=SearchConfig(precision=tier), step=step)
    v, i = np.asarray(v), np.asarray(i)
    for row in range(5):
        for val in np.unique(v[row]):
            same = i[row][v[row] == val]
            assert (np.diff(same) > 0).all(), (row, same)
            # the best copies are the lowest indices of that value
            assert (np.sort(same) == same).all()
    v0, i0 = topk_search(jnp.asarray(q), _served_values(c, tier), 30,
                         "dot")
    rtol, atol = _tol(tier)
    assert_topk_equivalent(i, v, np.asarray(i0), np.asarray(v0),
                           rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [None, 128, 300])
@pytest.mark.parametrize("metric", METRICS)
def test_mask_and_sentinels(metric, step):
    q, c = _data(3, m=6, n=900)
    keep = np.zeros(900, bool)
    keep[[3, 140, 141, 599, 898]] = True
    v, i = ft.fused_topk(jnp.asarray(q), jnp.asarray(c), 9, metric,
                         mask=jnp.asarray(keep), step=step)
    v, i = np.asarray(v), np.asarray(i)
    assert set(i[:, :5].ravel()) <= {3, 140, 141, 599, 898}
    assert (i[:, 5:] == BIG).all()
    worst = np.inf if metric == "euclidean" else -np.inf
    assert (v[:, 5:] == worst).all()
    v0, i0 = topk_search(jnp.asarray(q), jnp.asarray(c), 9, metric,
                         mask=jnp.asarray(keep))
    np.testing.assert_array_equal(i, np.asarray(i0))


@pytest.mark.parametrize("tier", TIERS)
def test_dead_rows_never_selected(tier):
    # dead (-inf bias) rows past n_valid, and every live score negative:
    # a leaked dead row would win with score 0
    r = np.random.default_rng(4)
    c = -np.abs(r.standard_normal((70, 16))).astype(np.float32)
    q = np.abs(r.standard_normal((3, 16))).astype(np.float32)
    cp, cbp = ft.prepare_corpus(jnp.asarray(c), "dot", precision=tier)
    pad = 58
    cp = jnp.pad(cp, ((0, pad), (0, 0)))
    cbp = jnp.concatenate([
        jnp.pad(cbp[:-1], ((0, 0), (0, pad))),
        jnp.pad(cbp[-1:], ((0, 0), (0, pad)), constant_values=-np.inf)])
    v, i = ft.fused_topk_prepared(jnp.asarray(q), cp, cbp, 80, "dot",
                                  config=SearchConfig(precision=tier),
                                  step=32)
    i = np.asarray(i)
    assert (i[:, :70] < 70).all()
    assert (i[:, 70:] == BIG).all()
    assert (np.asarray(v)[:, :70] < 0).all()


@pytest.mark.parametrize("step", [128, 256, None])
@pytest.mark.parametrize("tier", TIERS)
def test_probed_equals_restricted_oracle(tier, step):
    cfg = SearchConfig(block_q=8, block_n=128, precision=tier)
    q, c = _data(5, m=20, n=1280, d=32)
    cp, cbp = ft.prepare_corpus(jnp.asarray(c), "cosine", precision=tier)
    tiles = np.array([[0, 3, 7], [1, 2, 9], [4, 5, 6]], np.int32)
    v, i = ft.fused_topk_prepared(jnp.asarray(q), cp, cbp, 12, "cosine",
                                  config=cfg, tiles=jnp.asarray(tiles),
                                  step=step)
    cs = np.asarray(_served_values(c, tier))
    rtol, atol = _tol(tier)
    for b in range(3):
        rows = np.concatenate([np.arange(t * 128, (t + 1) * 128)
                               for t in tiles[b]])
        qb = q[8 * b: 8 * (b + 1)]
        v0, p0 = topk_search(jnp.asarray(qb), jnp.asarray(cs[rows]), 12,
                             "cosine")
        assert_topk_equivalent(np.asarray(i)[8 * b: 8 * (b + 1)],
                               np.asarray(v)[8 * b: 8 * (b + 1)],
                               rows[np.asarray(p0)], np.asarray(v0),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", METRICS)
def test_k_above_old_ceiling(metric):
    q, c = _data(6, m=4, n=3000, d=16)
    v, i = ft.fused_topk(jnp.asarray(q), jnp.asarray(c), 1500, metric,
                         config=SearchConfig(precision="highest"),
                         step=1024)
    v0, i0 = topk_search(jnp.asarray(q), jnp.asarray(c), 1500, metric)
    assert_topk_equivalent(np.asarray(i), np.asarray(v), np.asarray(i0),
                           np.asarray(v0))


@pytest.mark.parametrize("m", [1, 8, 256, 1000, 65536])
def test_step_rows_bounds_the_slabs(m):
    for width, tier in ((768, "bf16x3"), (768, "int8c"), (4096, "highest")):
        s = ft.step_rows(m, width, tier)
        assert s >= 1024 and s & (s - 1) == 0
        if s > 1024:  # above the floor both budgets hold
            assert 4 * m * s <= ft._SCORE_SLAB_BYTES
            assert width * 4 * s <= 2 * ft._CORPUS_SLAB_BYTES


def test_probe_block_count_and_tile_count_checked():
    q, c = _data(7, m=20, n=1000, d=32)
    cfg = SearchConfig(block_q=8, block_n=128)
    cp, cbp = ft.prepare_corpus(jnp.asarray(c), "cosine",
                                precision=cfg.precision)
    with pytest.raises(ValueError, match="query blocks"):
        ft.fused_topk_prepared(q, cp, cbp, 5, "cosine", config=cfg,
                               tiles=jnp.zeros((2, 2), jnp.int32))
    with pytest.raises(ValueError, match="tiles"):
        ft.fused_topk_prepared(q, cp, cbp, 5, "cosine", config=cfg,
                               tiles=jnp.zeros((3, 9), jnp.int32))


# ---------------------------------------------------------------------------
# The Triton step (GPU) in the Pallas interpreter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,bq,d,masked", [
    (1, 16, 64, False), (10, 16, 128, False), (16, 64, 64, False),
    (10, 32, 192, True), (5, 64, 128, True), (16, 16, 64, True)])
def test_triton_step_interpreted(k, bq, d, masked):
    ts = importlib.import_module("polars_matmul_tpu.kernels.triton_step")
    r = np.random.default_rng(10 + k)
    q = r.standard_normal((2 * bq, d)).astype(np.float32)
    c = r.standard_normal((512, d)).astype(np.float32)
    cp, cbp = ft.prepare_corpus(jnp.asarray(c), "dot", precision="bf16x3")
    qs = ft._prepare_queries(jnp.asarray(q), ft.Metric.DOT, "bf16x3", d)
    bias = cbp[0]
    keep = np.ones(512, bool)
    if masked:
        keep[r.choice(512, 400, replace=False)] = False
        bias = jnp.where(jnp.asarray(keep), bias, -jnp.inf)
    v, i = ts.step_candidates(qs[0], qs[1], cp, bias, k=k, bq=bq,
                              interpret=True)
    v, p = jax.lax.top_k(v, k)
    i = jnp.take_along_axis(i, p, axis=1)
    s = q.astype(np.float64) @ c.T.astype(np.float64)
    s = np.where(keep[None, :], s, -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    assert_topk_equivalent(np.asarray(i), np.asarray(v), order,
                           np.take_along_axis(s, order, axis=1),
                           rtol=2e-5, atol=1e-4)
    assert keep[np.asarray(i)].all()


# ---------------------------------------------------------------------------
# Every product names its precision (no f32 dot left to the TF32 default)
# ---------------------------------------------------------------------------


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


def _assert_named(closed):
    dots = list(_dots(closed.jaxpr))
    assert dots, "no product traced"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None, eqn
        f32_operand = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
        if f32_operand:
            named = (isinstance(prec, jax.lax.DotAlgorithmPreset)
                     or all(p == jax.lax.Precision.HIGHEST for p in prec))
            assert named, f"f32 product at {prec}: {eqn}"


@pytest.mark.parametrize("probed", [False, True])
@pytest.mark.parametrize("tier", TIERS)
def test_engine_products_name_precision(tier, probed):
    # width 64: the bf16x3 dense step also traces its Triton branch
    q, c = _data(8, m=16, n=512, d=64)
    cfg = SearchConfig(block_q=8, block_n=128, precision=tier)
    cp, cbp = ft.prepare_corpus(jnp.asarray(c), "cosine", precision=tier)
    tiles = jnp.asarray([[0, 2], [1, 3]], jnp.int32) if probed else None
    closed = jax.make_jaxpr(lambda q_, cp_, cb_: ft.fused_topk_prepared(
        q_, cp_, cb_, 5, "cosine", config=cfg, tiles=tiles, step=128))(
            jnp.asarray(q), cp, cbp)
    _assert_named(closed)


def _public_dot_fns():
    from polars_matmul_tpu.kernels.matmul import pairwise_matmul
    from polars_matmul_tpu.ops import cluster
    from polars_matmul_tpu.ops.reference import pairwise_scores

    x = jnp.ones((64, 16), jnp.float32)
    cent = jnp.ones((4, 16), jnp.float32)
    tc = jnp.arange(4, dtype=jnp.int32)
    return {
        "pairwise_matmul": (lambda: pairwise_matmul(x, x)),
        "pairwise_scores": (lambda: pairwise_scores(x, x, "euclidean")),
        "kmeans": (lambda: cluster.kmeans(x, 4, iters=2)),
        "assigner": (lambda: cluster.make_assigner(cent)(x)),
        "probe_tiles": (lambda: cluster.probe_tiles(
            x, cent, tc, p=2, tm=8, metric_v="cosine")),
        "oneshot": (lambda: ft.fused_topk(x, x, 3, "dot")),
    }


@pytest.mark.parametrize("name", ["pairwise_matmul", "pairwise_scores",
                                  "kmeans", "assigner", "probe_tiles",
                                  "oneshot"])
def test_public_products_name_precision(name):
    _assert_named(jax.make_jaxpr(_public_dot_fns()[name])())


# ---------------------------------------------------------------------------
# Start-up: no pyarrow needed, nothing picks a path from the backend
# ---------------------------------------------------------------------------


def test_import_without_pyarrow():
    code = (
        "import sys; sys.modules['pyarrow'] = None\n"
        "import numpy as np, polars_matmul_tpu as pmt\n"
        "q = np.eye(3, 8, dtype=np.float32)\n"
        "i, v = pmt.topk(q, np.eye(8, dtype=np.float32), 2)\n"
        "assert i[:, 0].tolist() == [0, 1, 2]\n"
        "try:\n"
        "    pmt.topk_arrow(None, None, 1)\n"
        "except ImportError as e:\n"
        "    assert 'pyarrow' in str(e)\n"
        "else:\n"
        "    raise SystemExit('topk_arrow ran without pyarrow')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def _sources():
    roots = ["polars_matmul_tpu", "examples", "tools"]
    files = [os.path.join(REPO, f) for f in ("bench.py", "chip_smoke.py")]
    for root in roots:
        for dirpath, _, names in os.walk(os.path.join(REPO, root)):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    return [f for f in files if os.path.exists(f)]


@pytest.mark.parametrize("pattern", ["default_backend", "interpret ="])
def test_no_backend_chosen_path(pattern):
    """No code path picks the interpreter or a CPU fallback from the
    backend it happens to run on: nothing reads the default backend or
    computes an ``interpret`` flag (tests pass it explicitly where a
    kernel has an interpreter)."""
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pattern in line:
                    hits.append(f"{os.path.relpath(path, REPO)}:{n}")
    assert not hits, hits


def test_only_gpu_pallas_routes():
    """The only Pallas route the code imports is Triton (the GPU one)."""
    import ast

    routes = set()
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.startswith("jax.experimental.pallas")):
                routes |= {node.module + "." + a.name for a in node.names}
            elif isinstance(node, ast.Import):
                routes |= {a.name for a in node.names
                           if a.name.startswith("jax.experimental.pallas")}
    assert routes <= {"jax.experimental.pallas",
                      "jax.experimental.pallas.triton"}, routes


# ---------------------------------------------------------------------------
# On the card (skip without one; chip_smoke.py runs them there)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("tier", TIERS)
def test_scan_on_gpu_matches_oracle(tier, gpu_device):
    q, c = _data(9, m=64, n=20000, d=256)
    with jax.default_device(gpu_device):
        v, i = ft.fused_topk(jnp.asarray(q), jnp.asarray(c), 10, "cosine",
                             config=SearchConfig(precision=tier), step=4096)
        v0, i0 = topk_search(jnp.asarray(q), _served_values(c, tier), 10,
                             "cosine")
    rtol, atol = _tol(tier)
    assert_topk_equivalent(np.asarray(i), np.asarray(v), np.asarray(i0),
                           np.asarray(v0), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("storage,tier", [("int8", "int8c"),
                                          ("int4", "int4c")])
def test_quantized_corpus_on_gpu_at_batch_256(storage, tier, gpu_device):
    """A resident quantized corpus at 1M x 768 with 256 queries: the size
    at which XLA's fused int8 -> bf16 GEMM once returned garbage rows."""
    import polars_matmul_tpu as pmt

    with jax.default_device(gpu_device):
        kq, kc = jax.random.split(jax.random.PRNGKey(12))
        q = jax.random.normal(kq, (256, 768), jnp.float32)
        c = jax.random.normal(kc, (1_000_000, 768), jnp.float32)
        handle = pmt.Corpus(np.asarray(c), storage=storage)
        n, d = c.shape
        codes, scales = handle._device[:n], handle._scales[:n]
        if storage == "int4":
            served = ft.dequant_int4(codes, scales, d)
        else:
            served = codes[:, :d].astype(jnp.float32) * scales[:, None]
        for k in (10, 100):
            i, v = handle.topk(np.asarray(q), k, "cosine")
            v0, i0 = topk_search(q, served, k, "cosine")
            assert np.isfinite(v).all()
            rtol, atol = _tol(tier)
            assert_topk_equivalent(np.asarray(i), np.asarray(v),
                                   np.asarray(i0), np.asarray(v0),
                                   rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_sharded_f32_default_tier_on_gpu(merge, gpu_device):
    """Corpus(mesh=...) over an f32 corpus at the default tier runs the
    Triton step inside shard_map (k <= 16)."""
    import polars_matmul_tpu as pmt

    q, c = _data(10, m=64, n=20000, d=256)
    mesh = pmt.make_mesh(1, 1, devices=[gpu_device])
    with jax.default_device(gpu_device):
        handle = pmt.Corpus(c, mesh=mesh, config=SearchConfig(merge=merge))
        i, v = handle.topk(q, 10, "cosine")
        v0, i0 = topk_search(jnp.asarray(q), jnp.asarray(c), 10, "cosine")
    rtol, atol = _tol("bf16x3")
    assert_topk_equivalent(np.asarray(i), np.asarray(v), np.asarray(i0),
                           np.asarray(v0), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_clustered_f32_unprobed_on_gpu(gpu_device):
    """ClusteredCorpus over f32 rows with probe=None scans densely at the
    default tier (the Triton step at k <= 16)."""
    import polars_matmul_tpu as pmt

    q, c = _data(11, m=64, n=20000, d=256)
    with jax.default_device(gpu_device):
        i, v = pmt.ClusteredCorpus(c, seed=0).topk(q, 10, "cosine",
                                                   probe=None)
        v0, i0 = topk_search(jnp.asarray(q), jnp.asarray(c), 10, "cosine")
    rtol, atol = _tol("bf16x3")
    assert_topk_equivalent(np.asarray(i), np.asarray(v), np.asarray(i0),
                           np.asarray(v0), rtol=rtol, atol=atol)
