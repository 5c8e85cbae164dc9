"""Run one cell of the benchmark of graphvite_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. The last
line of standard output is the result: correct, attempted, failed, the
cell's end-to-end metrics (--trace 0) or per-layer metrics (--trace 1),
the device, and last the numbers compared with the reference, each beside
its limit; the same numbers end standard error. Exits non-zero without a
result when there is no card, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def environment(root):
    """Every build and kernel cache inside the checkout, at fixed paths,
    and no library loading JAX on its own."""
    build = os.path.join(root, "build")
    os.environ["GRAPHVITE_TPU_TORCH_CACHE_DIR"] = os.path.join(build,
                                                               "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment(ROOT)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness, isolation

    manifest = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
    need = chips.get(args.workload)
    if need is None:
        print("no workload %r" % args.workload, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print("needs %d CUDA device(s); found %d" % (
            need, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", root=ROOT,
                      t_start=T_START)
    found = isolation.loaded_forbidden()
    if found:
        print("loaded in this process: %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
