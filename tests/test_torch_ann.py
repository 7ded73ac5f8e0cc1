"""Parity of the torch port's ANN engine (``tpu_lutvq_torch.ann``) with the
JAX package's (``tpu_lutvq.ann``).

Inputs are made with numpy from a seed.  Trained state (centroids,
codebooks, rotations) crosses from the JAX package through
``tpu_lutvq_torch.utils.convert``, since the two packages' random numbers
differ; the JAX scans run their Pallas kernels with ``interpret=True``, as
``tests/test_ann.py`` does, and the port's take their plain versions (CPU
tensors never reach a CUDA kernel).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.ann.pq as jpq
import tpu_lutvq.core as jcore
from tpu_lutvq.ann import OPQ as JOPQ
from tpu_lutvq.ann import ProductQuantizer as JPQ
from tpu_lutvq.ann import ResidualQuantizer as JRQ

import tpu_lutvq_torch.ann.opq as topq
import tpu_lutvq_torch.ann.pq as tpq
import tpu_lutvq_torch.core as tcore
from tpu_lutvq_torch.ann import OPQ, ProductQuantizer, kmeans
from tpu_lutvq_torch.utils import convert

# the packages' ``ann`` re-export the function ``kmeans`` over its module
jkm = importlib.import_module("tpu_lutvq.ann.kmeans")
tkm = importlib.import_module("tpu_lutvq_torch.ann.kmeans")

torch.set_num_threads(2)

REL = 1e-5  # search values: f32 sums taken in different orders
SCAN_F32_REL = 1e-6  # f32 and bf16 table scans, max|diff| / max|scores|


def clustered(seed, n=512, d=32, centers=16, noise=0.05):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((centers, d)).astype(np.float32)
    assign = rng.integers(0, centers, n)
    return (cents[assign] + noise * rng.standard_normal((n, d))).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def assert_codes_match(got, want, dist):
    """Codes equal, except where the two chosen entries' distances (``dist``
    (n, M, K), or (n, K) for one codebook) tie to f32 rounding."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    diff = np.argwhere(got != want)
    assert len(diff) <= max(1, got.size // 100), len(diff)
    d = np.asarray(dist)
    for idx in diff:
        row = d[tuple(idx)] if d.ndim == got.ndim + 1 else d[idx[0]]
        a, b = row[got[tuple(idx)]], row[want[tuple(idx)]]
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (idx, a, b)


def assert_topk_match(got, want, scores, rel=REL):
    """Search results agree: values rank by rank within ``rel`` of the
    largest score, and indices equal except ties, i.e. an index in one
    result and not in the other scores within that of the k-th value.
    ``scores`` holds every code's score, as the search computes it."""
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    scores = np.asarray(scores)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    tol = rel * np.abs(scores).max()
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    for row in range(gi.shape[0]):
        np.testing.assert_allclose(scores[row, gi[row]], gv[row], rtol=0, atol=tol)
        for i in set(gi[row].tolist()) ^ set(wi[row].tolist()):
            assert abs(scores[row, i] - wv[row, -1]) <= tol, (row, i)


def f32_scores(tables, codes):
    """Exact ADC scores from f32 tables, summed in subquantizer order."""
    tables, codes = np.asarray(tables, np.float32), np.asarray(codes).astype(np.int64)
    out = np.zeros((tables.shape[0], codes.shape[0]), np.float32)
    for m in range(codes.shape[1]):
        out += tables[:, m, codes[:, m]]
    return out


# ---- the scan -----------------------------------------------------------------


@pytest.mark.parametrize("q,variant,g,k", [
    (10, v, g, k) for v in ("auto", "f32", "i8", "i16") for g in (4, 16) for k in (16, 256)
] + [(1, "auto", 16, 16), (1, "auto", 16, 256)])
def test_scan_codes_matches_jax(q, variant, g, k):
    """Given the same numpy tables, int8 and int16 scans equal the JAX
    package's bit for bit; the f32 tables and the bf16 ones ("auto" from two
    queries up, and a lone query's K=256 pair kernel) within 1e-6.  G=4 pads
    to 8 groups; 10 queries make launches of 8 and 2."""
    rng = np.random.default_rng(g * k + q)
    tables = (10 * rng.standard_normal((q, g, k))).astype(np.float32)
    codes = rng.integers(0, k, (300, g)).astype(np.uint8)
    want = np.asarray(jpq._scan_codes(jcore.VQConfig(2 * g, g, 1, k), jnp.asarray(tables),
                                      jnp.asarray(codes), interpret=True, variant=variant))
    got = tpq._scan_codes(tcore.VQConfig(2 * g, g, 1, k), t(tables), t(codes),
                          variant=variant).numpy()
    assert got.shape == want.shape == (q, 300)
    if variant in ("i8", "i16"):
        assert np.array_equal(got, want)
    else:
        assert rel_err(got, want) <= SCAN_F32_REL


# ---- kmeans -------------------------------------------------------------------


def test_kmeans_assign_update_match_jax():
    x = clustered(0)
    c = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    want = np.asarray(jkm._assign(jnp.asarray(x), jnp.asarray(c)))
    got = tkm._assign(t(x), t(c)).numpy()
    dist = ((x[:, None] - c[None]) ** 2).sum(-1)
    assert_codes_match(got, want, dist)
    c_w, n_w = jkm._update(jnp.asarray(x), jnp.asarray(want), 16)
    c_g, n_g = tkm._update(t(x), torch.from_numpy(want.astype(np.int64)), 16)
    np.testing.assert_allclose(c_g.numpy(), np.asarray(c_w), rtol=1e-5, atol=1e-5)
    assert np.array_equal(n_g.numpy(), np.asarray(n_w))
    assert n_g.dtype == torch.float32


@pytest.mark.parametrize("k", [8, 16, 3])
def test_hypercube_init_matches_jax(k):
    x = clustered(2, d=16)
    want = np.asarray(jkm.hypercube_init(jax.random.PRNGKey(0), jnp.asarray(x), k))
    got = tkm.hypercube_init(t(x), k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_kmeans_recovers_clusters():
    """The JAX package's property test (tests/test_ann.py): within-cluster
    distance near the noise floor."""
    x = t(clustered(3))
    c, a = kmeans(torch.Generator().manual_seed(1), x, 16, iters=30)
    assert c.shape == (16, 32) and a.shape == (512,)
    assert float(((x - c[a]) ** 2).sum(dim=1).mean()) < 0.2


def test_kmeans_hypercube_and_seeded():
    x = t(clustered(4, n=256, d=16))
    c, a = kmeans(torch.Generator().manual_seed(2), x, 8, iters=10, init="hypercube")
    assert c.shape == (8, 16) and int(a.max()) < 8
    for init in ("kmeans++", "sample"):
        runs = [kmeans(torch.Generator().manual_seed(5), x, 8, iters=5, init=init)[0]
                for _ in range(2)]
        assert torch.equal(*runs)
    with pytest.raises(ValueError, match="init"):
        kmeans(torch.Generator(), x, 8, init="random")


# ---- PQ -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pq_pair():
    """A JAX-trained PQ(32, 4, 16), the port's copy, and the data."""
    x = clustered(5, n=600, centers=32)
    jp = JPQ(d=32, m=4, k=16).train(jax.random.PRNGKey(6), jnp.asarray(x), iters=20)
    return jp, convert.pq_from_numpy(jp, "cpu"), x


def test_pq_encode_decode_tables_match(pq_pair):
    jp, tp, x = pq_pair
    assert tp.centroids.device.type == "cpu" and tp.centroids.shape == (4, 16, 8)
    want = np.asarray(jp.encode(jnp.asarray(x)))
    got = tp.encode(t(x))
    assert got.dtype == torch.uint8
    dist = ((x.reshape(600, 4, 1, 8) - np.asarray(jp.centroids)[None]) ** 2).sum(-1)
    assert_codes_match(got.numpy(), want, dist)
    assert np.array_equal(tp.decode(t(want)).numpy(), np.asarray(jp.decode(jnp.asarray(want))))
    queries = x[:5] + 0.01
    for name in ("l2_tables", "ip_tables"):
        np.testing.assert_allclose(getattr(tp, name)(t(queries)).numpy(),
                                   np.asarray(getattr(jp, name)(jnp.asarray(queries))),
                                   rtol=1e-5, atol=1e-5)


def test_pq_encode_chunks(pq_pair, monkeypatch):
    _, tp, x = pq_pair
    whole = tp.encode(t(x))
    monkeypatch.setattr(tpq, "ENCODE_ROWS", 128)
    assert torch.equal(tp.encode(t(x)), whole)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("table_dtype", ["f32", "int8", "int16"])
def test_pq_search_matches_jax(pq_pair, metric, table_dtype):
    jp, tp, x = pq_pair
    codes = np.asarray(jp.encode(jnp.asarray(x[:512])))
    queries = x[512:518] + 0.01
    want = jp.search(jnp.asarray(queries), jnp.asarray(codes), topk=10, metric=metric,
                     table_dtype=table_dtype, interpret=True)
    got = tp.search(t(queries), t(codes), topk=10, metric=metric, table_dtype=table_dtype)
    assert got[1].dtype == torch.int64 and got[0].shape == (6, 10)
    tables = tp.l2_tables(t(queries)) if metric == "l2" else tp.ip_tables(t(queries))
    variant = {"int8": "i8", "int16": "i16"}.get(table_dtype, "auto")
    scores = tpq._scan_codes(tp.cfg, tables, t(codes), variant=variant).numpy()
    assert_topk_match(got, want, scores)
    if metric == "l2":
        assert bool((got[0][:, 1:] >= got[0][:, :-1]).all())
    else:
        assert bool((got[0][:, 1:] <= got[0][:, :-1]).all())


@pytest.mark.parametrize("data,shortlist", [("clustered", 64), ("uniform", 32)])
def test_pq_refined_search_is_exact(pq_pair, data, shortlist):
    """The refined search returns the exact f32-table top-k (the scan's
    guarantee), as the JAX package's does, and skips work where the
    bounds bite."""
    jp, tp, x = pq_pair
    if data == "clustered":
        db, queries = x[:512], x[:6]
    else:
        rng = np.random.RandomState(11)
        db = rng.randn(512, 32).astype(np.float32)
        queries = rng.randn(5, 32).astype(np.float32)
    codes = np.asarray(jp.encode(jnp.asarray(db)))
    stats_j, stats_t = {}, {}
    want = jp.search(jnp.asarray(queries), jnp.asarray(codes), topk=5, interpret=True,
                     refine_groups=2, shortlist=shortlist, stats=stats_j)
    got = tp.search(t(queries), t(codes), topk=5, refine_groups=2, shortlist=shortlist,
                    stats=stats_t)
    exact = f32_scores(tp.l2_tables(t(queries)).numpy(), codes)
    assert_topk_match(got, want, exact)
    assert_topk_match(got, tpq._top(torch.from_numpy(exact), 5, smallest=True), exact)
    assert 0 < stats_t["scored_frac"] <= 1.0
    if data == "clustered":
        assert stats_t["scored_frac"] < 0.7
    with pytest.raises(ValueError, match="metric='l2'"):
        tp.search(t(queries), t(codes), metric="ip", refine_groups=2)


def test_rq_parity():
    x = clustered(7, n=400, d=16, centers=8)
    jr = JRQ(d=16, n_codebooks=3, k=16).train(jax.random.PRNGKey(8), jnp.asarray(x), iters=15)
    tr = convert.rq_from_numpy(jr, "cpu")
    want = np.asarray(jr.encode(jnp.asarray(x)))
    got = tr.encode(t(x)).numpy()
    assert np.mean(got == want) >= 0.98  # a first-stage tie moves every later residual
    assert np.array_equal(tr.decode(t(want)).numpy().round(5),
                          np.asarray(jr.decode(jnp.asarray(want))).round(5))
    queries = x[:4]
    wres = jr.search(jnp.asarray(queries), jnp.asarray(want), topk=5, interpret=True)
    gres = tr.search(t(queries), t(want), topk=5)
    tables = torch.einsum("qd,nkd->qnk", t(queries), tr.codebooks)
    assert_topk_match(gres, wres, tpq._scan_codes(tr.cfg, tables, t(want)).numpy())
    mses = [float(((tr.decode(tr.encode(t(x))) - t(x)) ** 2).mean())]
    one = tpq.ResidualQuantizer(16, 1, 16, codebooks=tr.codebooks[:1])
    mses.append(float(((one.decode(one.encode(t(x))) - t(x)) ** 2).mean()))
    assert mses[0] < 0.7 * mses[1]  # more stages, lower residual


def test_mixed_pq_parity():
    x = clustered(9, n=400, d=24)
    jm = jpq.MixedPQ(d=24, ks=(32, 32, 64)).train(jax.random.PRNGKey(12), jnp.asarray(x),
                                                   iters=15)
    tm = convert.mixed_pq_from_numpy(jm, "cpu")
    assert tm.cfg.n_cluster == 64 and [c.shape[0] for c in tm.quantizers] == [32, 32, 64]
    want = np.asarray(jm.encode(jnp.asarray(x)))
    got = tm.encode(t(x)).numpy()
    assert np.mean(got == want) >= 0.99
    assert np.array_equal(tm.decode(t(want)).numpy(), np.asarray(jm.decode(jnp.asarray(want))))
    for metric in ("l2", "ip"):
        wres = jm.search(jnp.asarray(x[:4]), jnp.asarray(want), topk=5, metric=metric,
                         interpret=True)
        gres = tm.search(t(x[:4]), t(want), topk=5, metric=metric)
        assert_topk_match(gres, wres, bf16_scores_of(tm, x[:4], want, metric))


def bf16_scores_of(tm, queries, codes, metric):
    """Scores of every database code under a MixedPQ from bf16-rounded
    tables, the entries the scan of four queries sums."""
    out = np.zeros((len(queries), len(codes)), np.float32)
    for mm, c in enumerate(tm.quantizers):
        c = c.numpy()
        qs = queries[:, mm * tm.dsub:(mm + 1) * tm.dsub]
        tab = qs @ c.T
        if metric == "l2":
            tab = (qs ** 2).sum(1, keepdims=True) - 2 * tab + (c ** 2).sum(1)[None]
        tab = t(tab).to(torch.bfloat16).float().numpy()
        out += tab[:, codes[:, mm].astype(np.int64)]
    return out


def test_sdc_parity(pq_pair):
    jp, tp, x = pq_pair
    codes = np.asarray(jp.encode(jnp.asarray(x[:256])))
    qcodes = np.asarray(jp.encode(jnp.asarray(x[256:260])))
    sdc_w = np.asarray(jpq.sdc_tables(jp))
    sdc_g = tpq.sdc_tables(tp).numpy()
    np.testing.assert_allclose(sdc_g, sdc_w, rtol=1e-5, atol=1e-5)
    want = jpq.sdc_search(jp, jnp.asarray(qcodes), jnp.asarray(codes), topk=5, interpret=True)
    got = tpq.sdc_search(tp, t(qcodes), t(codes), topk=5)
    tables = tpq.sdc_tables(tp)[torch.arange(4)[None, :], t(qcodes).long()]
    assert_topk_match(got, want, tpq._scan_codes(tp.cfg, tables, t(codes)).numpy())


# ---- OPQ ----------------------------------------------------------------------


def anisotropic(seed, n=500, d=16):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d))
    mix, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (base @ np.diag(np.linspace(0.1, 3.0, d)) @ mix).astype(np.float32)


def test_opq_procrustes_step_matches_jax():
    """One rotation update given the same PQ and rotation: R = UVᵀ is unique
    for a nonsingular correlation, so the two packages agree."""
    x = anisotropic(0)
    r0, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((16, 16)))
    r0 = r0.astype(np.float32)
    jp = JPQ(d=16, m=4, k=16).train(jax.random.PRNGKey(2), jnp.asarray(x @ r0.T), iters=10)
    xr = jnp.asarray(x) @ jnp.asarray(r0).T
    rec = jp.decode(jp.encode(xr))
    u, _, vt = jnp.linalg.svd(rec.T @ jnp.asarray(x), full_matrices=False)
    want = np.asarray(u @ vt)
    got = topq.procrustes_step(convert.pq_from_numpy(jp, "cpu"), t(x), t(r0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    carried = convert.opq_from_numpy(JOPQ(16, 4, 16, rotation=jnp.asarray(want), pq=jp), "cpu")
    assert torch.equal(carried.rotation, t(want))
    assert torch.equal(carried.pq.centroids, t(jp.centroids))


def test_opq_rotation_orthogonal_and_helps():
    """The JAX package's property test: an orthogonal rotation that does at
    least as well as identity-rotation PQ on anisotropic data."""
    x = t(anisotropic(3))
    opq = OPQ(d=16, m=4, k=16).train(torch.Generator().manual_seed(11), x, outer_iters=5,
                                     kmeans_iters=10)
    r = opq.rotation
    torch.testing.assert_close(r @ r.T, torch.eye(16), atol=1e-4, rtol=0)
    pq = ProductQuantizer(d=16, m=4, k=16).train(torch.Generator().manual_seed(11), x, iters=10)
    mse_pq = float(((pq.decode(pq.encode(x)) - x) ** 2).mean())
    assert opq.reconstruction_mse(x) < mse_pq * 1.05


# ---- entry points default to the card ----------------------------------------


def _default_device_entry_points():
    from tpu_lutvq_torch.core import params
    from tpu_lutvq_torch.models import kv_cache, llama, paged_cache

    return [
        llama.init_caches, kv_cache.KVCache.init, paged_cache.PagedKVCache.init,
        params.tmac_codebook, convert.tensor_from_numpy, convert.packed_from_numpy,
        convert.llama_from_numpy, convert.kv_caches_from_numpy,
        convert.paged_caches_from_numpy, convert.pq_from_numpy, convert.rq_from_numpy,
        convert.mixed_pq_from_numpy, convert.opq_from_numpy,
    ]


@pytest.mark.parametrize("fn", _default_device_entry_points(), ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_has_no_cpu_fallback():
    """Without a card, an entry point left at its default raises rather
    than quietly making CPU tensors; with one, it makes CUDA tensors."""
    from tpu_lutvq_torch.models.llama import LlamaConfig, init_caches

    cfg = LlamaConfig.tiny(n_layers=1, max_seq=8)
    jq = JPQ(d=8, m=2, k=4, centroids=jnp.zeros((2, 4, 4)))
    calls = [lambda: init_caches(cfg, 1), lambda: convert.pq_from_numpy(jq),
             lambda: convert.tensor_from_numpy(np.zeros(3, np.float32))]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            first = out[0].k_q if isinstance(out, tuple) else getattr(out, "centroids", out)
            assert first.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
