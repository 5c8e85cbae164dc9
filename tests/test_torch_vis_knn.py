"""The port's KNN graph construction (graphvite_tpu_torch/knn.py) against
the JAX package's (graphvite_tpu/knn.py), on the CPU, from numpy-seeded
vectors. On the CPU the reference's `approx_max_k` is exact, so its
default route is compared.

Tolerances: `perplexity_weights` bit-identical (the same numpy code);
`perplexity_weights_device` rtol 1e-5 (atol 1e-9) with the bisection
run to float32 resolution (tol 0); at the default stop, |entropy - log
perplexity| < 1e-5, two float32 exps can stop a row's bisection one step
apart, so 98% of rows are held to rtol 1e-5 and every weight to rtol
3e-4 (1.1e-4 measured); `exact_knn` distances rtol 1e-4 (the self
column, a difference of two equal numbers, atol 1e-4 of the row's
squared norm) and labels equal wherever the neighbour's distance
gap to both sides exceeds 1e-4 relative; `ivf_knn` (clustered rows,
nlist 64, nprobe 8) mean per-row label overlap >= 0.98 with the
reference's and both recalls within 0.02; `KNNGraph` on the exact route:
heads and tails identical, weights rtol 5e-4 (3.6e-4 measured; atol
1e-6 of a row's unit mass for raw, unnormalized vectors, whose larger
norms cancel more): the
distances agree at rtol 1e-4 (|x|^2 + |y|^2 - 2 x.y cancels, and the two
float32 products sum in different orders), and a weight exp(-beta d)
moves by beta * d times that; the weights from the same distances are
held to the reference's pipeline as above (96% of edges at rtol 1e-5),
and the reciprocal averaging exactly."""
import numpy as np
import pytest
import torch

from graphvite_tpu import knn as ref
from graphvite_tpu_torch import knn as port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores (see tests/test_torch_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clusters(n, d, c, seed, spread=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32) * spread
    labels = rng.integers(0, c, n)
    x = centers[labels] + rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), labels


def test_perplexity_weights_bit_identical():
    rng = np.random.default_rng(1)
    d = (rng.random((300, 40)) * 3).astype(np.float32)
    for perplexity in (5.0, 15.0, 30.0):
        np.testing.assert_array_equal(port.perplexity_weights(d, perplexity),
                                      ref.perplexity_weights(d, perplexity))


def test_perplexity_weights_device_matches_reference():
    rng = np.random.default_rng(2)
    d = (rng.random((256, 50)) * 4).astype(np.float32)
    d[:, 0] = 0.0                       # a zero distance, as a duplicate row
    for perplexity in (5.0, 10.0, 20.0):
        got = port.perplexity_weights_device(torch.as_tensor(d), perplexity,
                                             tol=0.0)
        want = np.asarray(ref.perplexity_weights_device(d, perplexity,
                                                        tol=0.0))
        # weights under 1e-9 of a row's unit sum: exp of a large argument
        # keeps the argument's rounding times its size
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)
        got = port.perplexity_weights_device(torch.as_tensor(d), perplexity)
        want = np.asarray(ref.perplexity_weights_device(d, perplexity))
        assert got.device == CPU and got.dtype == torch.float32
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=1e-9)
        rows_ok = np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-9,
                         axis=1)
        assert rows_ok.mean() >= 0.98
        ent = -(got * np.log(got + 1e-30)).sum(1)
        np.testing.assert_allclose(ent, np.log(perplexity), atol=1e-3)


def test_exact_knn_matches_reference():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((800, 32)).astype(np.float32)
    k = 20
    dist, labels = port.exact_knn(v, k, row_chunk=300, device="cpu")
    rdist, rlabels = ref.exact_knn(v, k)
    dist, labels = dist.numpy(), labels.numpy()
    assert dist.shape == labels.shape == (800, k + 1)
    assert (labels[:, 0] == np.arange(800)).all()
    sqn = (v.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(dist[:, 0], rdist[:, 0], rtol=0,
                               atol=1e-4 * sqn.max())
    np.testing.assert_allclose(dist[:, 1:], rdist[:, 1:], rtol=1e-4)
    # labels wherever the neighbour is separated from both sides by more
    # than 1e-4 relative (float64 distances, one more rank for the gap)
    d2 = ((v[:, None, :].astype(np.float64) - v[None]) ** 2).sum(-1)
    s = np.sort(d2, axis=1)[:, :k + 2]
    gap = np.minimum(np.diff(s, axis=1)[:, :-1],
                     np.diff(s, axis=1)[:, 1:])[:, :k]
    clear = gap > 1e-4 * s[:, 1:k + 1]
    assert clear.mean() > 0.9
    assert np.array_equal(labels[:, 1:][clear], rlabels[:, 1:][clear])
    assert (np.diff(dist, axis=1) >= 0).all()


def test_exact_knn_on_a_tensor_keeps_its_device():
    v = torch.as_tensor(np.random.default_rng(4).standard_normal((50, 6)),
                        dtype=torch.float32)
    dist, labels = port.exact_knn(v, 70)       # k + 1 > n: all n columns
    assert dist.device == CPU and labels.shape == (50, 50)
    assert (labels[:, 0] == torch.arange(50)).all()


def _overlap(a, b):
    """Mean per-row share of b's distinct labels that a also holds."""
    return np.mean([len(set(x) & set(y)) / len(set(y))
                    for x, y in zip(a.tolist(), b.tolist())])


def test_ivf_knn_matches_reference():
    x, _ = _clusters(6000, 16, 24, seed=5)
    k = 10
    kw = dict(nlist=64, nprobe=8, sample=4096, seed=0)
    timings = {}
    dist, labels = port.ivf_knn(x, k, device="cpu", timings=timings, **kw)
    rdist, rlabels = ref.ivf_knn(x, k, **kw)
    dist, labels = dist.numpy(), labels.numpy()
    assert labels.shape == (6000, k) and np.isfinite(dist).all()
    assert (labels != np.arange(6000)[:, None]).all(), "self excluded"
    assert sorted(timings) == ["assign", "kmeans", "queries"]
    assert _overlap(labels, rlabels) >= 0.98
    rec = port.knn_recall(x, labels, nq=300, device="cpu")
    rrec = ref.knn_recall(x, rlabels, nq=300)
    assert abs(rec - rrec) <= 0.02 and rec > 0.85, (rec, rrec)
    # the exact search scores the same labels the same
    assert abs(port.knn_recall(x, rlabels, nq=300, device="cpu")
               - rrec) <= 1e-3
    assert (dist[:, :-1] <= dist[:, 1:]).all()


def test_ivf_knn_bf16_rows_keep_float32_distances():
    """The rows are bfloat16 but the products and norms float32: the
    distances equal float32 math on the bf16-rounded rows."""
    x, _ = _clusters(1500, 24, 8, seed=6)
    dist, labels = port.ivf_knn(x, 5, nlist=16, nprobe=16, device="cpu")
    xb = torch.as_tensor(x).bfloat16().double()
    want = ((xb[:, None, :] - xb[labels]) ** 2).sum(-1).float()
    np.testing.assert_allclose(dist.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_ivf_unfilled_slots_take_the_reference_fallback():
    """Clusters too small for k candidates: the empty slots get the
    largest finite distance and the row's first label, as in the
    reference."""
    x, _ = _clusters(200, 8, 40, seed=7, spread=20.0)
    kw = dict(nlist=64, nprobe=2, sample=200, seed=1)
    dist, labels = port.ivf_knn(x, 15, device="cpu", **kw)
    rdist, rlabels = ref.ivf_knn(x, 15, **kw)
    dist, labels = dist.numpy(), labels.numpy()
    assert np.isfinite(dist).all()
    # the filled slots, where the reference filled them
    filled = rdist == rdist.max()
    assert filled.sum() > filled.any(axis=1).sum()
    np.testing.assert_array_equal(dist == dist.max(), filled)
    first = np.broadcast_to(labels[:, :1], labels.shape)
    assert (labels[filled & (labels != first)].size
            <= filled.any(axis=1).sum())
    assert _overlap(labels, rlabels) >= 0.98


def _ref_reciprocal(heads, tails, w, n, kind):
    key = heads * n + tails
    rkey = tails * n + heads
    order = np.argsort(key, kind=kind)
    skey = key[order]
    pos = np.minimum(np.searchsorted(skey, rkey), skey.size - 1)
    has = skey[pos] == rkey
    rw = np.where(has, w[order][pos], 0.0)
    return np.where(has, (w + rw) / 2.0, w).astype(np.float32)


def test_reciprocal_average_matches_reference_formula():
    rng = np.random.default_rng(8)
    n, k = 300, 12
    heads = np.repeat(np.arange(n), k)
    tails = np.concatenate([rng.choice(np.delete(np.arange(n), i), k,
                                       replace=False) for i in range(n)])
    w = rng.random(n * k)
    got = port.reciprocal_average(torch.as_tensor(heads),
                                  torch.as_tensor(tails),
                                  torch.as_tensor(w, dtype=torch.float32), n)
    # unique keys: the reference's unstable sort gives the same result
    want = _ref_reciprocal(heads, tails, w.astype(np.float32)
                           .astype(np.float64), n, "quicksort")
    np.testing.assert_array_equal(got.numpy(), want)
    # repeated keys (the IVF fallback can repeat a label): the port's
    # stable sort averages with the first copy in edge order
    tails[5:8] = tails[4]
    heads[tails[4] * k] = 0
    tails[tails[4] * k] = heads[4]
    got = port.reciprocal_average(torch.as_tensor(heads),
                                  torch.as_tensor(tails),
                                  torch.as_tensor(w, dtype=torch.float32), n)
    want = _ref_reciprocal(heads, tails, w.astype(np.float32)
                           .astype(np.float64), n, "stable")
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_graph_exact_route_matches_reference():
    x, _ = _clusters(400, 12, 5, seed=9)
    g = port.KNNGraph(device="cpu").load_numpy(x, num_neighbor=10,
                                               perplexity=5)
    r = ref.KNNGraph().load_numpy(x, num_neighbor=10, perplexity=5)
    assert (g.num_vertex, g.num_edge, g.num_neighbor) == (400, 4000, 10)
    np.testing.assert_array_equal(g.edge_heads.numpy(), r.edge_heads)
    np.testing.assert_array_equal(g.edge_tails.numpy(), r.edge_tails)
    np.testing.assert_allclose(g.edge_weights.numpy(), r.edge_weights,
                               rtol=5e-4)
    np.testing.assert_array_equal(g.vertex_weights, r.vertex_weights)
    # the same distances through the reference's weight pipeline
    x_n = g._normalize(x)
    dist, labels = port.exact_knn(x_n, 10, device="cpu")
    dist = dist[:, 1:].numpy()
    heads = np.repeat(np.arange(400), 10)
    want = _ref_reciprocal(
        heads, labels[:, 1:].reshape(-1).numpy(),
        np.asarray(ref.perplexity_weights_device(dist, 5.0)).reshape(-1)
        .astype(np.float64), 400, "quicksort")
    got = g.edge_weights.numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4)
    # a row whose bisection stops a step apart also moves its reverse
    # edges' averages
    assert np.mean(np.abs(got - want) <= 1e-5 * want) >= 0.96
    assert g.info() == r.info()
    assert sorted(g.build_seconds) == ["knn", "perplexity", "reciprocal"]
    # no normalization, and a tensor input, still on the exact route
    g2 = port.KNNGraph(device="cpu").load_numpy(
        torch.as_tensor(x), num_neighbor=10, perplexity=5,
        vector_normalization=False)
    r2 = ref.KNNGraph().load_numpy(x, num_neighbor=10, perplexity=5,
                                   vector_normalization=False)
    np.testing.assert_array_equal(g2.edge_tails.numpy(), r2.edge_tails)
    np.testing.assert_allclose(g2.edge_weights.numpy(), r2.edge_weights,
                               rtol=5e-4, atol=1e-6)


def test_knn_graph_auto_switches_to_ivf(monkeypatch):
    x, _ = _clusters(3000, 16, 12, seed=10)
    monkeypatch.setattr(port.KNNGraph, "IVF_THRESHOLD", 2000)
    g = port.KNNGraph(device="cpu").load_numpy(x, num_neighbor=8,
                                               perplexity=4, nprobe=8)
    assert sorted(g.build_seconds) == ["assign", "kmeans", "knn",
                                       "perplexity", "queries", "reciprocal"]
    assert g.num_edge == 3000 * 8
    assert (g.edge_heads != g.edge_tails).all()
    _, labels = port.ivf_knn(g._normalize(x), 8, nprobe=8, device="cpu")
    np.testing.assert_array_equal(g.edge_tails.numpy(),
                                  labels.reshape(-1).numpy())
    w = g.edge_weights.numpy()
    assert np.isfinite(w).all() and (w >= 0).all()


def test_knn_graph_load_file(tmp_path):
    x, _ = _clusters(120, 4, 3, seed=11)
    f = tmp_path / "vectors.txt"
    f.write_text("# a comment\n" + "\n".join(
        " ".join("%.6f" % v for v in row) for row in x) + "\n")
    g = port.KNNGraph(device="cpu").load_file(str(f), num_neighbor=6,
                                              perplexity=3)
    r = ref.KNNGraph().load_file(str(f), num_neighbor=6, perplexity=3)
    np.testing.assert_array_equal(g.edge_tails.numpy(), r.edge_tails)
    np.testing.assert_allclose(g.edge_weights.numpy(), r.edge_weights,
                               rtol=5e-4)
