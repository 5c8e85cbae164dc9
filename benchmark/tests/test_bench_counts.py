"""The counting functions against hand counts at tiny shapes, the trace
arithmetic on synthetic intervals, and the isolation checks."""
import types

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import isolation, peaks, trace
from benchmark.counts import deepwalk, rotate, scatter_add


def test_kernel1_bytes_and_ops_by_hand():
    # 5 int64 ids over 3 distinct rows in range, one dropped (id 9 >= 8);
    # width 4, float32 table
    ids = torch.tensor([2, 2, 5, 7, 9])
    nbytes, ops = scatter_add.call_counts(ids, rows=8, width=4,
                                          elem_bytes=4)
    assert nbytes == 5 * 8 + 5 * 4 * 4 + 2 * 3 * 4 * 4
    assert ops == 4 * 4


def test_least_seconds_picks_the_larger_bound():
    t, by = peaks.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = peaks.least_seconds(1.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def deepwalk_cfg(D=4):
    return {"resource": {"dim": D, "float_type": "float32"}}


def test_deepwalk_step_counts_by_hand():
    # one walk of 3 vertices, offsets +-1: pairs (0,1),(1,2),(1,0),(2,1)
    chain = torch.tensor([[3, 5, 3]])
    mask = torch.zeros((1, 3, 2), dtype=torch.bool)
    mask[0, 0, 0] = mask[0, 1, 0] = True       # forward pairs
    mask[0, 1, 1] = mask[0, 2, 1] = True       # backward pairs
    pool = torch.tensor([[5, 8]])              # G 1, M 2
    steps = [{"chain": chain, "mask": mask.float(), "pool": pool}]
    ops, nbytes = deepwalk.per_batch(deepwalk_cfg(), steps)
    D, M, pairs, active = 4, 2, 4, 3
    assert ops == 6 * D * pairs + 6 * D * M * active + 4 * D * (2 * 3 + 2)
    # vertex rows {3, 5}, context rows {3, 5, 8}; ids 3 + 2
    assert nbytes == 2 * D * 4 * (2 + 3) + 8 * 5


def test_rotate_step_counts_by_hand():
    cfg = {"resource": {"dim": 4, "float_type": "float32"}}
    steps = [{"heads": torch.tensor([0, 1]), "tails": torch.tensor([1, 2]),
              "rels": torch.tensor([0, 0]),
              "negatives": torch.tensor([[2, 3]])}]
    ops, nbytes = rotate.per_batch(cfg, steps)
    B, M, G, Dh, D = 2, 2, 1, 2, 4
    assert ops == Dh * (14 * B * (M + 1) + 20 * B) + 2 * D * (3 * B + G * M)
    # entity rows {0, 1, 2, 3}, one relation row
    assert nbytes == 2 * D * 4 * (4 + 1) + 8 * (3 * B + G * M)


def event(name, dev, start, dur, corr=0, linked=0, thread=1, card=0):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev,
        start_ns=lambda: start, duration_ns=lambda: dur,
        correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
        start_thread_id=lambda: thread, device_index=lambda: card)


def test_idle_share_and_scatter_time_on_synthetic_intervals():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    evs = [
        event(trace.WINDOW, cpu, 0, 1000, corr=1),
        event("Activity Buffer Request", cpu, 5, 2),
        event("aten::mul", cpu, 10, 5, corr=2),
        event(trace.SCATTER, cpu, 100, 50, corr=3),
        event("aten::sort", cpu, 110, 5, corr=4),
        # a kernel launched through ctypes: linked to no operation
        event("cudaLaunchKernel", cpu, 120, 3, corr=90),
        # the device-side copy of the window range is no device activity
        event(trace.WINDOW, cuda, 0, 1000),
        # kernels [20, 120) and [100, 200) overlap; [500, 600); [620, 660);
        # a copy [700, 750); one past the window is cut at its end
        event("mul_kernel", cuda, 20, 100, corr=50, linked=2),
        event("sort_kernel", cuda, 100, 100, corr=51, linked=4),
        event("add_kernel", cuda, 500, 100, corr=52, linked=3),
        event("gv_kernel", cuda, 620, 40, corr=90),
        event("Memcpy DtoD", cuda, 700, 50, corr=53, linked=2),
        event("late_kernel", cuda, 950, 100, corr=54, linked=2),
    ]
    s = trace.summarize(evs)
    assert s["window_s"] == pytest.approx(1000e-9)
    busy = 180 + 100 + 40 + 50 + 50
    assert s["busy_s"] == pytest.approx(busy * 1e-9)
    assert s["kernels"] == 5
    # sort_kernel (its operation inside the range), add_kernel (linked to
    # the range) and gv_kernel (launched inside it)
    assert s["scatter_kernels"] == 3
    assert s["scatter_device_s"] == pytest.approx(240e-9)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx((20 + 40 + 200) * 1e-9)
    assert gaps[trace.SCATTER] == pytest.approx((300 + 20) * 1e-9)
    assert sum(gaps.values()) == pytest.approx(1e-6 - busy * 1e-9)
    assert trace.WINDOW not in dict(s["device_ops"])


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"graphvite_tpu_torch.solver": 1, "graphvite_tpu_torch": 1,
            "numpy": 1}
    assert isolation.loaded_forbidden(mods) == []
    mods["graphvite_tpu.ops"] = 1
    mods["jaxlib"] = 1
    assert isolation.loaded_forbidden(mods) == ["graphvite_tpu", "jaxlib"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert isolation.reference_imports_program() == []
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom graphvite_tpu_torch.ops import steps\n")
    good = tmp_path / "good.py"
    good.write_text("import torch\nfrom benchmark import init\n")
    assert isolation.reference_imports_program([str(bad), str(good)]) == [
        "bad.py"]


def test_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    from benchmark import harness

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.deepwalk, benchmark.reference.rotate\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
            "print(bad); sys.exit(1 if bad else 0)"
            % (harness.ROOT, isolation.PROGRAM))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
