"""The gate of chip_smoke.py's kg_mesh phase: config/demo/math.yaml cut to
dim 128 and 500 epochs with `gpus: [0, 0]` (two workers: the sharded KG
engine, global negatives by the auto rule) through the JAX package's CLI
on a virtual 8-device CPU mesh, and, with --port, through the PyTorch
port's CLI on two CPU workers. Prints each filtered tail MRR as JSON.

    PYTHONPATH=. JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/kg_mesh_math_gate.py [--port]

The math fixture is generated offline into a temporary dataset directory.
"""
import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config_text(root):
    with open(os.path.join(HERE, "config", "demo", "math.yaml")) as f:
        text = f.read()
    for old, new in (("dim: 512", "dim: 128\n  gpus: [0, 0]"),
                     ("num_epoch: 2000", "num_epoch: 500"),
                     ("file_name: rotate_math.pkl",
                      "file_name: %s" % os.path.join(root, "m.pkl"))):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def run_configs(runs, root):
    """Each (name, CLI module) of `runs` on the cut config; prints and
    returns {name: record}."""
    out = {}
    for name, module in runs:
        cmd = importlib.import_module(module)
        path = os.path.join(root, "math_%s.yaml" % name)
        text = config_text(root)
        if name == "torch":
            text = text.replace("gpus: [0, 0]", "gpus: [0, 0]\n  device: cpu")
        with open(path, "w") as f:
            f.write(text)
        app, results = cmd.run_config(cmd.load_config(path))
        out[name] = {"MRR": float(results[0]["MRR"]),
                     "workers": app.solver.num_worker,
                     "batches": int(app.solver.batch_id),
                     "batch": int(app.solver.effective_batch)}
        print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's CLI on two CPU workers")
    args = ap.parse_args()
    root = tempfile.mkdtemp(prefix="kg_mesh_gate_")
    # the registry reads the dataset path when it is first imported
    os.environ["GRAPHVITE_DATASET_PATH"] = root
    sys.path.insert(0, HERE)
    runs = [("jax", "graphvite_tpu.cmd")]
    if args.port:
        runs.append(("torch", "graphvite_tpu_torch.cmd"))
    try:
        run_configs(runs, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
