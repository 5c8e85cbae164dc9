"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
                                 [--control] [--fault <fault>]

For each seed: set-up's followed steps through the program, one call of
the window's size (its first step is the window step the check
follows), the program freed, then the numbers compared. Per seed one
JSON line: the program's numbers
(`program`; with `--fault`, those of the program with the fault
planted, faults.py) and, with `--control`, the control's: the plain
reference computed in bfloat16, the precision below the configuration's
float32, in the program's place (`control`). The lower reading of a limit
is the largest that sound runs give, the upper the smallest that the
control or a fault gives.
"""
import argparse
import contextlib
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload, seed, device, control=False, fault=None, root=ROOT):
    import torch

    from benchmark import faults, harness

    manifest = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    _, cfg, traffic = harness.cell_files(manifest, workload, root)
    app = importlib.import_module("benchmark.apps." + cfg["application"])
    job = app.Job(cfg, traffic, seed, device)
    ctx = faults.planted(fault, job) if fault else contextlib.nullcontext()
    with ctx:
        job.set_up()
        job.call()
    job.release()

    def numbers(dtype):
        compared, unbounded = harness.check(job, cfg, dtype)
        return dict({k: v for k, (v, _) in compared.items()}, **unbounded)

    out = {"seed": seed, "fault": fault, "program": numbers(torch.float32)}
    if control:
        out["control"] = numbers(torch.bfloat16)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import run

    run.environment(ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, "cuda", args.control,
                                  args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
