"""The port's walk sampler (ops/device_sampler.py): the banded emitter and
the chain function match the JAX package exactly on the same inputs (the
chain fed the reference's own uniforms); the port's own draws hold up
statistically, as tests/test_device_sampler.py holds the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvite_tpu.ops.device_sampler as ref
import graphvite_tpu_torch.ops.device_sampler as port
from graphvite_tpu.graph import Graph as RefGraph
from graphvite_tpu_torch.graph import Graph


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the cores: with torch's default of one thread
    per core, each of the many tiny ops these tests run waits on the other
    workers' threads (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("aug", [1, 3])
@pytest.mark.parametrize("bidir", [False, True])
def test_walk_offsets_and_banded_emission_match(aug, bidir):
    rng = np.random.default_rng(aug)
    L1, W = 9, 5
    chain = rng.integers(0, 50, (L1, W)).astype(np.int32)
    alive = rng.random((L1, W)) > 0.2
    alive[:2] = True
    valid = np.cumprod(alive, axis=0) > 0
    assert port.walk_offsets(aug, bidir) == ref.walk_offsets(aug, bidir)
    ct_r, pm_r = ref.emit_walk_banded(jnp.asarray(chain), jnp.asarray(valid),
                                      aug, bidir=bidir)
    ct_p, pm_p = port.emit_walk_banded(torch.as_tensor(chain).long(),
                                       torch.as_tensor(valid), aug,
                                       bidir=bidir)
    np.testing.assert_array_equal(ct_p.numpy(), np.asarray(ct_r))
    np.testing.assert_array_equal(pm_p.numpy(), np.asarray(pm_r))
    assert pm_p.dtype == torch.float32


def _edges(weighted, seed=0):
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(150):
        u, v = rng.integers(40, size=2)
        if u != v:
            e = (str(u), str(v))
            edges.append(e + (float(rng.random() * 3 + 0.1),) if weighted
                         else e)
    # sinks: directed edges into vertices with no out-edges
    for i in range(20):
        edges.append((str(i), "sink%d" % i) + ((1.0,) if weighted else ()))
    return edges


def _reference_draws(key, W, L):
    """The uniforms the reference's chain function draws from `key`
    (device_sampler.py:248-267), rebuilt with the same key splits."""
    kk = jax.random.split(key, 3)
    u1 = jax.random.uniform(kk[0], (W,))
    u2 = jax.random.uniform(kk[1], (W,))
    ks = jax.random.split(kk[2], 2)
    w1s = jax.random.uniform(ks[0], (L - 1, W))
    w2s = jax.random.uniform(ks[1], (L - 1, W))
    return tuple(torch.as_tensor(np.array(x)) for x in (u1, u2, w1s, w2s))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("undirected", [True, False])
def test_chain_matches_reference_from_its_draws(weighted, undirected):
    edges = _edges(weighted)
    L, aug = 8, 2
    T = aug * (2 if undirected else 1)
    batch = 6 * T * (L + 1)
    samplers = []
    g = RefGraph().load_edge_list(edges, as_undirected=undirected)
    samplers.append(ref.DeviceWalkSampler.build(g, aug, L, batch, banded=True,
                                                bidir=undirected))
    g = Graph().load_edge_list(edges, as_undirected=undirected)
    samplers.append(port.DeviceWalkSampler.build(g, aug, L, batch,
                                                 banded=True,
                                                 bidir=undirected))
    s_ref, s_port = samplers
    assert s_ref.uniform == s_port.uniform == (not weighted)
    W = s_ref.num_walk
    assert s_port.num_walk == W
    ref_fn = ref.make_walk_chain_fn(s_ref.uniform, L, W)
    port_fn = port.make_walk_chain_fn(s_port.uniform, L, W)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        chain_r, valid_r = ref_fn(key, *s_ref.arrays())
        chain_p, valid_p = port_fn(*s_port.arrays(),
                                   draws=_reference_draws(key, W, L))
        np.testing.assert_array_equal(chain_p.numpy(), np.asarray(chain_r))
        np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_r))
    if not undirected:
        assert not valid_p.all()   # some walks reached the sink


@pytest.mark.parametrize("own_draws", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("start_csr", [False, True])
def test_chain_dispatch_keeps_plain_body_on_cpu(start_csr, weighted,
                                                own_draws):
    """On CPU tensors the first-order chain runs the plain body: the
    chain function's (chain [L+1, W] int64, valid [L+1, W] bool) equal
    walk_chain_plain's from the same draws, no kernel launch is counted,
    and drawing for itself it takes randint(W), rand(W) where a start
    alias table exists, and rand(L-1, W) twice from its generator."""
    g = Graph().load_edge_list(_edges(weighted), as_undirected=False)
    L, aug = 8, 2
    if start_csr and weighted:
        with pytest.raises(ValueError, match="equal edge weights"):
            port.DeviceWalkSampler.build(g, aug, L, 6 * aug * (L + 1),
                                         banded=True, start_csr=True)
        return
    s = port.DeviceWalkSampler.build(g, aug, L, 6 * aug * (L + 1),
                                     banded=True, start_csr=start_csr)
    W = s.num_walk
    fn = s.make_chain_fn()
    gen = torch.Generator().manual_seed(4)
    n_start = s.indices.numel() if start_csr else s.heads.numel()
    draws = (torch.randint(0, n_start, (W,), generator=gen),
             torch.rand(W, generator=gen) if weighted else None,
             torch.rand(L - 1, W, generator=gen),
             torch.rand(L - 1, W, generator=gen))
    after = gen.get_state()
    launches = port.walk_chain.launches
    if own_draws:
        gen.manual_seed(4)
        chain, valid = fn(*s.arrays(), generator=gen)
        assert torch.equal(gen.get_state(), after)
    else:
        chain, valid = fn(*s.arrays(), draws=draws)
    want = port.walk_chain_plain(*s.arrays(), *draws, start_csr=start_csr)
    assert port.walk_chain.launches == launches
    assert chain.shape == valid.shape == (L + 1, W)
    assert chain.dtype == torch.int64 and valid.dtype == torch.bool
    assert torch.equal(chain, want[0]) and torch.equal(valid, want[1])
    assert bool(valid[:2].all()) and not bool(valid[-1].all())


def test_chain_kernel_refuses_other_devices():
    """The chain runs on CUDA tensors (the kernel) or CPU tensors (the
    plain body); any other device raises, with no fallback."""
    e = torch.zeros(0, device="meta")
    u1 = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port.walk_chain(e, e, e, e, e, e, e, e, u1, None,
                        torch.zeros(3, 4, device="meta"),
                        torch.zeros(3, 4, device="meta"))


def _collect(sampler, rounds, seed=0):
    """(heads, tails) of every valid banded pair over `rounds` batches."""
    fn = sampler.make_sample_fn(sampler.batch_size)
    gen = torch.Generator().manual_seed(seed)
    offs = port.walk_offsets(sampler.augmentation_step, sampler.bidir)
    hs, ts = [], []
    for _ in range(rounds):
        ct, _, pm = fn(*sampler.arrays(), generator=gen)
        L1 = ct.shape[1]
        for t_i, k in enumerate(offs):
            pos = torch.arange(L1)
            ok = (pos + k >= 0) & (pos + k < L1)
            heads = ct[:, ok]
            tails = ct[:, (pos + k)[ok]]
            m = pm[:, ok, t_i] > 0
            hs.append(heads[m].numpy())
            ts.append(tails[m].numpy())
    return np.concatenate(hs), np.concatenate(ts)


def _build(g, aug, L, walks, bidir):
    T = aug * (2 if bidir else 1)
    return port.DeviceWalkSampler.build(g, aug, L, walks * T * (L + 1),
                                        banded=True, bidir=bidir)


def test_walk_pairs_are_paths():
    n = 12
    g = Graph().load_edge_list([(str(i), str((i + 1) % n)) for i in range(n)])
    s = _build(g, 2, 6, 32, bidir=True)
    h, t = _collect(s, 5)
    ids = np.array([int(x) for x in g.id2name])
    d = np.minimum((ids[t] - ids[h]) % n, (ids[h] - ids[t]) % n)
    assert (d <= 2).all()
    assert (d == 1).any() and (d == 2).any()


def test_dead_ends_are_masked():
    # directed path 0 -> 1 -> 2; walks die at 2
    g = Graph().load_edge_list([("0", "1"), ("1", "2")], as_undirected=False)
    s = _build(g, 3, 5, 16, bidir=False)
    fn = s.make_sample_fn(s.batch_size)
    ct, _, pm = fn(*s.arrays(), generator=torch.Generator().manual_seed(0))
    assert (pm > 0).any() and (pm == 0).any()
    h, t = _collect(s, 3)
    ids = np.array([int(x) for x in g.id2name])
    assert (ids[t] > ids[h]).all() and (ids[t] - ids[h] <= 3).all()


def test_weighted_neighbor_choice():
    """Transition frequencies from a hub follow the edge weights."""
    edges = [("0", "1", 1.0), ("0", "2", 3.0), ("0", "3", 6.0),
             ("1", "0", 1.0), ("2", "0", 1.0), ("3", "0", 1.0)]
    g = Graph().load_edge_list(edges, as_undirected=False)
    s = _build(g, 1, 4, 512, bidir=False)
    assert not s.uniform
    h, t = _collect(s, 8)
    zero = g.name2id["0"]
    counts = np.array([np.sum(t[h == zero] == g.name2id[str(i)])
                       for i in (1, 2, 3)], dtype=np.float64)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.3, 0.6],
                               atol=0.03)


def test_banded_shapes_and_valid_fraction():
    """Whole walks: chain [W, L+1] twice and a [W, L+1, T] mask whose mean
    is 1 - 2*(1+..+aug)/(T*(L+1)) on a sink-free graph."""
    rng = np.random.default_rng(0)
    e = rng.integers(0, 500, (4000, 2))
    e = e[e[:, 0] != e[:, 1]]
    g = Graph().load_edge_list([tuple(map(str, x)) for x in e])
    s = port.DeviceWalkSampler.build(g, 2, 40, 164 * 8, banded=True,
                                     bidir=True)
    ct, ct2, pm = s.make_sample_fn(164 * 8)(
        *s.arrays(), generator=torch.Generator().manual_seed(1))
    assert ct.shape == (8, 41) and pm.shape == (8, 41, 4)
    assert ct2 is ct
    np.testing.assert_allclose(float(pm.mean()), 1 - 6 / 164, atol=1e-6)

