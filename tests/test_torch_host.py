"""The port's host data against the JAX package: Graph CSR and name maps,
alias tables (native and numpy construction) and device_sample, from the same
inputs; and the small host API (Optimizer.info, utils.common.sigmoid and
device_profile)."""
import numpy as np
import pytest
import torch

import graphvite_tpu.graph as ref_graph
import graphvite_tpu.ops.alias as ref_alias
import graphvite_tpu_torch.graph as port_graph
import graphvite_tpu_torch.native as port_native
import graphvite_tpu_torch.ops.alias as port_alias


def _edge_list(seed=0, n=40, m=200, weighted=True):
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(m):
        u, v = rng.integers(n, size=2)
        name_u, name_v = "n%d" % u, "n%d" % v
        edges.append((name_u, name_v, float(rng.random() + 0.1))
                     if weighted else (name_u, name_v))
    return edges


GRAPH_ARRAYS = ["edge_heads", "edge_tails", "edge_weights", "indptr",
                "indices", "csr_weights", "csr_edge_ids", "vertex_weights"]


def _assert_same_graph(a, b):
    assert a.num_vertex == b.num_vertex
    assert a.num_edge == b.num_edge
    assert a.id2name == b.id2name
    assert a.name2id == b.name2id
    for name in GRAPH_ARRAYS:
        # weights pass through the same float32 numpy ops: exact
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("undirected,normalization,weighted", [
    (True, False, False), (True, True, True), (False, False, True)])
def test_graph_matches_reference(undirected, normalization, weighted):
    edges = _edge_list(weighted=weighted)
    a = ref_graph.Graph().load_edge_list(edges, undirected, normalization)
    b = port_graph.Graph().load_edge_list(edges, undirected, normalization)
    _assert_same_graph(a, b)


def test_graph_load_file_matches_reference(tmp_path):
    path = tmp_path / "edges.txt"
    lines = ["# comment line"] + ["%s\t%s\t%g" % e for e in _edge_list(1)]
    path.write_text("\n".join(lines) + "\n")
    a = ref_graph.Graph().load_file(str(path))
    b = port_graph.Graph().load_file(str(path))
    _assert_same_graph(a, b)


def _weights(seed, n):
    return np.random.default_rng(seed).random(n) ** 3 + 1e-3


@pytest.fixture(params=["native", "numpy"])
def alias_route(request, monkeypatch):
    """Build the alias tables of BOTH packages through one route."""
    if request.param == "numpy":
        monkeypatch.setattr(ref_alias, "_native", None)
        monkeypatch.setattr(port_native, "load", lambda: None)
    else:
        assert ref_alias._native is not None
        assert port_native.load() is not None
    return request.param


def test_alias_table_matches_reference(alias_route):
    w = _weights(0, 300)
    a = ref_alias.AliasTable(w)
    b = port_alias.AliasTable(w)
    np.testing.assert_array_equal(a.alias, b.alias)
    np.testing.assert_array_equal(a.prob, b.prob)
    for x, y in zip(ref_alias.device_alias_arrays(a),
                    port_alias.device_alias_arrays(b)):
        np.testing.assert_array_equal(x, y)


def test_packed_alias_tables_match_reference(alias_route):
    w = _weights(1, 120)
    offsets = np.array([0, 3, 3, 40, 41, 120])
    a = ref_alias.PackedAliasTables(w, offsets)
    b = port_alias.PackedAliasTables(w, offsets)
    np.testing.assert_array_equal(a.alias, b.alias)
    np.testing.assert_array_equal(a.prob, b.prob)


def test_native_and_numpy_alias_agree(monkeypatch):
    """The host-only fallback gives the native code's tables: the same
    aliases, and probabilities equal up to float64 summation order."""
    w = _weights(2, 500)
    offsets = np.array([0, 7, 7, 200, 500])
    native = port_alias.AliasTable(w)
    native_packed = port_alias.PackedAliasTables(w, offsets)
    monkeypatch.setattr(port_native, "load", lambda: None)
    plain = port_alias.AliasTable(w)
    plain_packed = port_alias.PackedAliasTables(w, offsets)
    for x, y in ((native, plain), (native_packed, plain_packed)):
        np.testing.assert_array_equal(x.alias, y.alias)
        np.testing.assert_allclose(x.prob, y.prob, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("packed", [True, False])
def test_device_sample_matches_reference(packed):
    import jax.numpy as jnp

    table = ref_alias.AliasTable(_weights(3, 257))
    arrays = ref_alias.device_alias_arrays(table)
    if not packed:
        arrays = (table.prob.astype(np.float32),
                  table.alias.astype(np.int32))
    rng = np.random.default_rng(4)
    u1 = rng.random((6, 50), dtype=np.float32)
    u2 = rng.random((6, 50), dtype=np.float32)
    want = np.asarray(ref_alias.device_sample(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(u1), jnp.asarray(u2)))
    got = port_alias.device_sample(
        *(torch.as_tensor(a) for a in arrays), torch.as_tensor(u1),
        torch.as_tensor(u2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_level_draw_reaches_every_column():
    """torch.rand's float32 uniforms are k 2^-24 for k in [0, 2^24), so
    the reference's first pick min(int(u n), n - 1) reaches at most 2^24
    columns: at n = 2^25 only the even ones, and on an unweighted table
    (every prob 1) an odd column is never drawn. When the port draws for
    itself over an unpacked table (the layout of n >= 2^24) the column is
    an integer over [0, n) (`alias_draws`; ROADMAP queue 3). A caller that
    passes float uniforms still gets the reference's rule. The tables
    here are zero-stride views: no 2^25-entry build."""
    n = 1 << 25
    prob = torch.ones(()).expand(n)
    alias = torch.zeros((), dtype=torch.int32).expand(n)
    gen = torch.Generator().manual_seed(0)
    u1, u2 = torch.rand(1 << 16, generator=gen), torch.rand(1 << 16,
                                                           generator=gen)
    floats = port_alias.device_sample(prob, alias, u1, u2)
    assert bool((floats % 2 == 0).all())
    idx, u = port_alias.alias_draws((prob, alias), (1 << 16,), gen)
    assert idx.dtype == torch.int64 and u.is_floating_point()
    got = port_alias.device_sample(prob, alias, idx, u)
    np.testing.assert_array_equal(got.numpy(), idx.numpy())
    assert int((got % 2 == 1).sum()) > (1 << 16) // 3
    assert int(got.min()) >= 0 and int(got.max()) < n
    # the packed layout (n < 2^24) keeps the float draw, which reaches
    # every column there
    packed = torch.ones(()).expand(1000, 2)
    u1, _ = port_alias.alias_draws((packed,), (8,), gen)
    assert u1.is_floating_point()


# ---------------------------------------------------------------------------
# the small host API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["SGD", "Momentum", "AdaGrad", "RMSprop",
                                  "Adam"])
def test_optimizer_info_matches_reference(rule):
    import graphvite_tpu.optim as ref_optim
    import graphvite_tpu_torch.optim as port_optim

    kw = dict(type=rule, lr=0.0125, weight_decay=3e-4, schedule="constant",
              momentum=0.9, alpha=0.95, beta1=0.8, beta2=0.999,
              epsilon=1e-6)
    assert (port_optim.Optimizer(**kw).info()
            == ref_optim.Optimizer(**kw).info())
    assert (port_optim.Optimizer(type=rule).info()
            == ref_optim.Optimizer(type=rule).info())


def test_sigmoid_matches_reference():
    from graphvite_tpu.utils.common import sigmoid as ref_sigmoid
    from graphvite_tpu_torch.utils.common import sigmoid

    x = np.array([-800.0, -30.0, -1.5, 0.0, 0.25, 30.0, 800.0])
    got = sigmoid(x)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref_sigmoid(x))
    assert got[0] == 0.0 and got[3] == 0.5 and got[-1] == 1.0
    assert np.isfinite(got).all()
    x32 = np.linspace(-5, 5, 11, dtype=np.float32)
    np.testing.assert_array_equal(sigmoid(x32), ref_sigmoid(x32))


def test_device_profile_writes_a_trace(tmp_path, caplog):
    from graphvite_tpu_torch.utils.common import device_profile

    trace_dir = tmp_path / "trace"
    with caplog.at_level("INFO", logger="graphvite_tpu_torch"):
        with device_profile(str(trace_dir)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(trace_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    text = files[0].read_text()
    assert "traceEvents" in text and "aten::mm" in text
    assert str(files[0]) in caplog.text
