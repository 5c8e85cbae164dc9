"""The port's spans and counters (utils/tracing.py) on the CPU: off costs
no clock read and no profiler range, a recording session holds every span
of a training call with its parent, batch and counts, stored spans agree
with the profiler's ranges, the valid-pair counter equals the pair flags
the steps receive, recording changes no loss and no table bit, set-up
stages are timed, the existing pieces (Monitor, device_profile, the mesh
ranges) record through it, and the benchmark's five readers of it read a
number from a tiny traced call and nothing where it has no spans."""
import json
import os

import numpy as np
import pytest
import torch

from graphvite_tpu_torch.graph import Graph, KnowledgeGraph
from graphvite_tpu_torch.ops import steps as port_steps
from graphvite_tpu_torch.solver import GraphSolver, KnowledgeGraphSolver
from graphvite_tpu_torch.utils import tracing

T = tracing
# the banded walk step on separate tables, the benchmark's fused arena
# (the walk step without the trust clip), the pooled KG step
ROUTES = ("walk", "fused", "kg")
# spans of one training call on each route: name -> its parent's name
PARENTS = {T.PREPARE: T.TRAIN, T.EPISODE: T.TRAIN, T.FINISH: T.TRAIN,
           T.SAMPLE: T.EPISODE, T.STEP: T.EPISODE, T.NEGATIVES: T.STEP,
           T.UPDATE: T.STEP, T.TRAIN: None}
READERS = ("sampler_share", "update_share", "call_overhead_share",
           "pair_yield", "setup_program_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _power_law(num_vertex, num_edge, seed):
    rng = np.random.default_rng(seed)
    u = (rng.random(num_edge) ** 2.5 * num_vertex).astype(np.int64)
    v = (rng.random(num_edge) ** 2.5 * num_vertex).astype(np.int64)
    keep = u != v
    return u[keep], v[keep]


def _walk_graph():
    u, v = _power_law(400, 2400, 11)
    g = Graph()
    g.num_vertex, g.num_edge = 400, int(u.size)
    g.id2name = g.name2id = None
    g.as_undirected = True
    g.edge_heads = np.concatenate([u, v])
    g.edge_tails = np.concatenate([v, u])
    g.edge_weights = np.ones(g.edge_heads.size, dtype=np.float32)
    g._finalize(normalization=False)
    return g


def _walk_solver(seed=5):
    """DeepWalk on the banded walk route, the benchmark cell's layout
    (augmentation 5, walks of 41, both directions: 380 of each walk's
    410 pair slots are pairs): 8 walks a batch, 2 batches an episode."""
    s = GraphSolver(dim=8, device="cpu", seed=seed)
    s.build(_walk_graph(), num_negative=1, batch_size=4000, episode_size=2)
    return s


def _mesh_solver(seed=5):
    """The same DeepWalk on the walks engine of two CPU workers (the mesh
    cell's engine): one episode of 2 batches a worker."""
    s = GraphSolver(dim=8, device="cpu", seed=seed, num_worker=2)
    s.build(_walk_graph(), num_negative=1, batch_size=4000, episode_size=2)
    return s


def _kg_solver(seed=5):
    """RotatE on the pooled KG step (the benchmark cell's, which the
    auto rule picks at its widths): batches of 256 triplets."""
    rng = np.random.default_rng(3)
    kg = KnowledgeGraph()
    kg.num_vertex, kg.num_relation, kg.num_edge = 300, 5, 3000
    kg.id2entity = kg.entity2id = kg.id2relation = kg.relation2id = None
    kg.edge_heads = rng.integers(0, 300, 3000)
    kg.edge_tails = rng.integers(0, 300, 3000)
    kg.edge_relations = rng.integers(0, 5, 3000)
    kg.edge_weights = np.ones(3000, dtype=np.float32)
    s = KnowledgeGraphSolver(dim=8, device="cpu", seed=seed)
    s.build(kg, num_negative=4, batch_size=256, episode_size=2)
    return s


def _fused_solver(seed=5):
    s = _walk_solver(seed)
    s._trust = "0"
    return s


SOLVERS = {"walk": _walk_solver, "fused": _fused_solver, "kg": _kg_solver,
           "mesh": _mesh_solver}


def _train(solver, batches=4, resume=False):
    """A call that trains `batches` batches (from the start, or resumed)."""
    trust = os.environ.get("GRAPHVITE_TRUST")
    os.environ["GRAPHVITE_TRUST"] = getattr(solver, "_trust", "0.25")
    try:
        if solver.model is None:
            kg = isinstance(solver, KnowledgeGraphSolver)
            solver._kw = (dict(model="RotatE", margin=6,
                               adversarial_temperature=0.2,
                               negative_sharing=True) if kg
                          else dict(model="DeepWalk", augmentation_step=5,
                                    random_walk_length=40,
                                    negative_weight=5))
            solver.train(num_epoch=1e-12, log_frequency=10**9,
                         **solver._kw)
        b0 = solver.batch_id if resume else 0
        num_epoch = ((b0 + batches) * solver.effective_batch
                     / solver.graph.num_edge + 1e-9)
        solver.train(num_epoch=num_epoch, resume=resume,
                     log_frequency=10**9, **solver._kw)
    finally:
        if trust is None:
            del os.environ["GRAPHVITE_TRUST"]
        else:
            os.environ["GRAPHVITE_TRUST"] = trust
    assert solver.batch_id == b0 + batches
    assert getattr(solver, "_banded_fused", False) == (
        getattr(solver, "_trust", "") == "0")
    return solver


@pytest.mark.parametrize("route", ROUTES)
def test_no_session_reads_no_clock_and_opens_no_range(route, monkeypatch):
    solver = _train(SOLVERS[route]())
    before = tracing._last

    def boom(*args, **kwargs):
        raise AssertionError("tracing ran with no session")

    monkeypatch.setattr(tracing, "_clock", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    _train(solver)
    assert tracing._last is before and tracing._session is None
    assert tracing.span(T.STEP) is tracing.OFF


def _session_of(route, batches=4):
    solver = SOLVERS[route]()
    _train(solver)                    # builds the sampler
    with tracing.recording():
        _train(solver, batches)
    return solver, tracing.last_session()


@pytest.mark.parametrize("route", ROUTES)
def test_recording_holds_every_span_with_its_parent(route):
    solver, s = _session_of(route)
    by_id = {sp.id: sp for sp in s["raw"]}
    parents = dict(PARENTS)
    # the negative alias table was built by the call before the session
    # (test_negative_table_is_built_once)
    assert {sp.name for sp in s["raw"]} == set(parents)
    for sp in s["raw"]:
        parent = by_id.get(sp.parent)
        assert (parent.name if parent else None) == parents[sp.name], sp
    stats = s["spans"]
    ep = solver._episode_batches()
    assert stats[T.TRAIN]["count"] == 1
    assert stats[T.PREPARE]["count"] == stats[T.FINISH]["count"] == 1
    assert stats[T.STEP]["count"] == 4 and stats[T.SAMPLE]["count"] == 4
    assert stats[T.EPISODE]["count"] == -(-4 // ep)
    assert stats[T.NEGATIVES]["count"] == stats[T.UPDATE]["count"] == 4
    # the spans of one batch share its index
    steps = sorted((sp for sp in s["raw"] if sp.name == T.STEP),
                   key=lambda sp: sp.start_ns)
    assert [sp.batch for sp in steps] == [0, 1, 2, 3]
    for sp in s["raw"]:
        if sp.name in (T.NEGATIVES, T.UPDATE):
            assert sp.batch == by_id[sp.parent].batch
    # self time = duration - the children's durations, per name
    child = {}
    for sp in s["raw"]:
        if sp.parent is not None:
            child[sp.parent] = (child.get(sp.parent, 0)
                                + sp.end_ns - sp.start_ns)
    for name, st in stats.items():
        own = sum(sp.end_ns - sp.start_ns - child.get(sp.id, 0)
                  for sp in s["raw"] if sp.name == name)
        assert st["self_s"] == pytest.approx(own * 1e-9, abs=1e-12)
        assert st["device_s"] == pytest.approx(st["host_s"])
    assert s["dropped"] == 0


@pytest.mark.parametrize("route", ["walk", "mesh"])
def test_prepare_ends_before_the_first_episode(route):
    """The shared episode loop's stages: `prepare` ends before the first
    episode span starts, `finish` starts after the last one ends, on a
    device route and on a mesh route."""
    _, s = _session_of(route)
    (prepare,) = [sp for sp in s["raw"] if sp.name == T.PREPARE]
    (finish,) = [sp for sp in s["raw"] if sp.name == T.FINISH]
    episodes = [sp for sp in s["raw"] if sp.name == T.EPISODE]
    assert episodes
    assert prepare.end_ns <= min(sp.start_ns for sp in episodes)
    assert finish.start_ns >= max(sp.end_ns for sp in episodes)
    train = [sp for sp in s["raw"] if sp.name == T.TRAIN][0]
    assert prepare.parent == finish.parent == train.id


def test_negative_table_is_built_once():
    """The degree-power negative table: built inside the first call's
    `prepare`, then kept for later calls on the graph and exponent."""
    solver = _walk_solver()
    with tracing.recording():
        _train(solver)                   # two calls, from a new solver
    raw = tracing.last_session()["raw"]
    by_id = {sp.id: sp for sp in raw}
    assert [by_id[sp.parent].name for sp in raw
            if sp.name == T.ALIAS_BUILD
            and by_id[sp.parent].name == T.PREPARE] == [T.PREPARE]
    with tracing.recording():
        _train(solver)
    assert T.ALIAS_BUILD not in tracing.last_session()["spans"]


def test_raw_spans_are_capped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    with tracing.recording():
        for i in range(8):
            with tracing.span(T.STEP, batch=i):
                pass
    s = tracing.last_session()
    assert len(s["raw"]) == 5 and s["dropped"] == 3
    assert s["spans"][T.STEP]["count"] == 8


def test_stages_end_with_their_span():
    with tracing.recording():
        tracing.stage(T.PREPARE)          # no span to end it: not opened
        with tracing.span(T.TRAIN):
            tracing.stage(T.PREPARE)
            tracing.stage(None)
            with tracing.span(T.EPISODE):
                pass
            tracing.stage(T.FINISH)
    s = tracing.last_session()
    assert {n: v["count"] for n, v in s["spans"].items()} == {
        T.TRAIN: 1, T.PREPARE: 1, T.EPISODE: 1, T.FINISH: 1}
    train = [sp for sp in s["raw"] if sp.name == T.TRAIN][0]
    assert all(sp.parent == train.id for sp in s["raw"] if sp is not train)


def test_stored_spans_agree_with_the_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile, record_function

    solver = _train(_walk_solver())
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("warm-up"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(solver, 2)
    events = prof.profiler.kineto_results.events()
    s = tracing.last_session()
    assert s["spans"][T.TRAIN]["count"] == 1
    stored = {}
    for sp in s["raw"]:
        stored.setdefault(sp.name, []).append((sp.start_ns, sp.end_ns))
    ranges = {}
    for ev in events:
        if ev.name() in stored:
            ranges.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    for name, spans in stored.items():
        got = sorted(ranges[name])
        assert len(got) == len(spans), name
        for (s0, s1), (r0, r1) in zip(sorted(spans), got):
            assert abs(s0 - r0) < 100_000 and abs(s1 - r1) < 100_000, name
    # the profiler's session ended with its call: the next call records
    # nothing, and a second profiler gets a session of its own
    _train(solver, 2)
    assert tracing._session is None
    assert tracing.last_session()["spans"][T.TRAIN]["count"] == 1
    with profile(activities=[ProfilerActivity.CPU]):
        _train(solver, 1)
    again = tracing.last_session()
    assert again["spans"][T.TRAIN]["count"] == 1
    assert again["spans"][T.STEP]["count"] == 1


@pytest.mark.parametrize("route", ROUTES)
def test_valid_pairs_are_the_pair_flags_the_steps_receive(route,
                                                          monkeypatch):
    """As the benchmark's job records them (benchmark/apps/graph.py): the
    mask each step of the runner receives."""
    masks = []
    make = port_steps.make_fused_runner

    def make_recorded(step_fn, *args, **kwargs):
        def step(state, *rest, mask=None, generator=None):
            masks.append(mask.clone())
            return step_fn(state, *rest, mask=mask, generator=generator)
        return make(step, *args, **kwargs)

    monkeypatch.setattr(port_steps, "make_fused_runner", make_recorded)
    solver, s = _session_of(route)
    c = s["counters"]
    got = masks[-4:]
    assert c[T.PAIR_SLOTS] == sum(m.numel() for m in got)
    assert c[T.VALID_PAIRS] == float(sum(m.double().sum() for m in got))
    if route != "kg":
        assert c[T.VALID_PAIRS] / c[T.PAIR_SLOTS] == pytest.approx(
            380 / 410, abs=1e-12)
    else:
        assert c[T.VALID_PAIRS] == c[T.PAIR_SLOTS] == 4 * 256


@pytest.mark.parametrize("route", ROUTES)
def test_recording_changes_no_loss_and_no_table(route):
    runs = []
    for on in (False, True):
        solver = _train(SOLVERS[route]())
        if on:
            with tracing.recording():
                _train(solver, 4, resume=True)
        else:
            _train(solver, 4, resume=True)
        runs.append((solver.batch_losses.clone(),
                     [t.clone() for t in solver.state["tables"]]))
    (loss_off, tabs_off), (loss_on, tabs_on) = runs
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(tabs_off, tabs_on))


def test_setup_stages_are_always_timed():
    before = {k: v["count"] for k, v in tracing.setup_totals().items()}
    _train(_walk_solver())
    after = tracing.setup_totals()
    for stage in (T.GRAPH_FINALIZE, T.SOLVER_BUILD, T.SAMPLER_BUILD):
        assert after[stage]["count"] >= before.get(stage, 0) + 1
        assert 0 <= after[stage]["self_seconds"] <= after[stage]["seconds"]


def test_monitor_stage_and_device_profile_record_spans(tmp_path):
    from graphvite_tpu_torch.utils.common import Monitor, device_profile

    mon = Monitor()
    solver = _train(_walk_solver())
    with device_profile(str(tmp_path)):
        with mon.stage("train"):
            _train(solver, 2)
    s = tracing.last_session()
    assert s["spans"]["train"]["count"] == 1
    top = [sp for sp in s["raw"] if sp.name == "train"][0]
    assert [sp.parent for sp in s["raw"] if sp.name == T.TRAIN] == [top.id]
    assert mon.summary()["train"]["calls"] == 1
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {T.TRAIN, T.STEP, T.UPDATE} <= names


def test_mesh_ranges_are_spans():
    """Each collective is a span of its name on every worker (its device
    seconds are per card)."""
    from graphvite_tpu_torch.parallel.mesh import DeviceGroup

    group = DeviceGroup(["cpu"] * 2)
    xs = [torch.arange(4.0), torch.arange(4.0) + 4]
    with tracing.recording():
        out = group.ring_shift(xs)
        group.all_gather(xs)
    assert torch.equal(out[1], xs[0])
    spans = tracing.last_session()["spans"]
    assert spans["mesh::ring_shift"]["count"] == 2
    assert spans["mesh::all_gather"]["count"] == 2


class _Ctx:
    """What a per-layer reader reads of a traced call (harness.Trace)."""

    def __init__(self, batches):
        self.batches = batches
        self.detail = {}


@pytest.mark.parametrize("metric", READERS)
def test_benchmark_readers(metric, monkeypatch):
    from benchmark import harness

    read = harness.metric_reader(metric)
    _session_of("walk")
    ctx = _Ctx(4)
    value = read(ctx)
    assert isinstance(value, float) and value > 0
    if metric == "pair_yield":
        assert value == pytest.approx(100 * 380 / 410)
    elif metric != "setup_program_s":
        assert value < 100
    assert ctx.detail
    # no session and no set-up stage: nothing to read
    monkeypatch.setattr(tracing, "_last", None)
    monkeypatch.setattr(tracing, "_setup", {})
    assert read(_Ctx(4)) is None
    # a session without the metric's spans or counters
    with tracing.recording():
        with tracing.span("other"):
            pass
    assert read(_Ctx(4)) is None
