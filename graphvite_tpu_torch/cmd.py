"""Command line: new | run | visualize | baseline | list (the port of
graphvite_tpu/cmd.py).

    python -m graphvite_tpu_torch.cmd baseline quick start
    python -m graphvite_tpu_torch.cmd run my_config.yaml [--epoch N]

The same YAML experiment format and the same `config/` directory as the
reference (ref python/graphvite/cmd.py:270, subcommands :193-267):
sections application / resource / format / graph / build / train /
evaluate / [load] / [save], `auto` -> the auto sentinel, and
`<dataset.key>` resolved through graphvite_tpu_torch.dataset. The files are
read by the port's own YAML reader (utils/yaml_lite.py). A run is on CUDA
unless the config's `resource:` section says `device: cpu`; without CUDA
it raises, as every entry point of the port does.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import shutil

import numpy as np

from graphvite_tpu_torch.utils import yaml_lite
from graphvite_tpu_torch.utils.common import auto, recursive_map

CONFIG_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config")


def get_config_path():
    env = os.environ.get("GRAPHVITE_CONFIG_PATH")
    return env or CONFIG_PATH


def load_config(config_file):
    """YAML -> dict with auto / <dataset.key> substitution
    (ref cmd.py:82-106)."""
    from graphvite_tpu_torch import dataset as ds
    from graphvite_tpu_torch.optim import Optimizer

    def get_dataset(x):
        if not isinstance(x, str):
            return x
        m = re.match(r"<(\w+[\w-]*)\.(\w+)>", x)
        if not m:
            return x
        name, key = m.groups()
        d = ds.DATASETS.get(name) or getattr(ds, name, None)
        if d is None:
            raise ValueError("unknown dataset `%s`" % name)
        return getattr(d, key)

    cfg = yaml_lite.load_file(config_file)
    cfg = recursive_map(cfg, lambda x: auto if x == "auto" else x)
    cfg = recursive_map(cfg, get_dataset)
    build = cfg.get("build", {})
    if isinstance(build.get("optimizer"), dict):
        build["optimizer"] = Optimizer(**build["optimizer"])
    g = cfg.get("graph", {})
    if isinstance(g.get("vectors"), str) and g["vectors"].endswith(".npy"):
        g["vectors"] = np.load(g["vectors"])
    return cfg


def run_config(cfg, do_eval=True, num_epoch=None):
    """Execute a loaded config end-to-end (ref cmd.py run/baseline body).
    The `resource` section goes to the application: `dim`, the types,
    `device` (CUDA when absent) and `gpus` (more than one trains on the
    multi-device engines, one worker per entry, worker i on cuda:gpus[i]:
    `gpus: [0, 0]` puts two workers on one card; knowledge graphs are
    not ported to them yet)."""
    from graphvite_tpu_torch.application import Application

    resource = dict(cfg.get("resource", {}))
    resource.pop("cpu_per_gpu", None)
    app = Application(cfg["application"], **resource)
    load_kwargs = dict(cfg.get("graph", {}))
    if "file_name" in load_kwargs:
        # the `format` section supplies parser options (cmd.py:118-124)
        for k, v in cfg.get("format", {}).items():
            load_kwargs.setdefault(k, v)
    app.load(**load_kwargs)
    app.build(**cfg.get("build", {}))
    if "load" in cfg:
        app.load_model(**cfg["load"])
    train_kwargs = dict(cfg.get("train", {}))
    if num_epoch is not None:
        train_kwargs["num_epoch"] = num_epoch
    app.train(**train_kwargs)
    results = []
    if do_eval and "evaluate" in cfg:
        evaluations = cfg["evaluate"]
        if isinstance(evaluations, dict):
            evaluations = [evaluations]
        for ev in evaluations:
            ev = dict(ev)
            task = ev.pop("task")
            results.append(app.evaluate(task, **ev))
    if "save" in cfg:
        app.save_model(**cfg["save"])
    return app, results


# -- subcommands -----------------------------------------------------------

def new_main(args):
    template_path = os.path.join(get_config_path(), "template")
    config = "_".join(args.application) + ".yaml"
    template = os.path.join(template_path, config)
    if args.file:
        config = args.file
    if not os.path.isfile(template):
        names = sorted(os.path.splitext(os.path.basename(t))[0]
                       .replace("_", " ")
                       for t in glob.glob(os.path.join(template_path,
                                                       "*.yaml")))
        raise ValueError("no template for `%s`; available: %s"
                         % (" ".join(args.application), ", ".join(names)))
    if os.path.exists(config) and not args.force:
        raise IOError("`%s` exists; use --force to overwrite" % config)
    shutil.copyfile(template, config)
    print("A configuration template has been written into `%s`." % config)


def run_main(args):
    cfg = load_config(args.config)
    run_config(cfg, do_eval=args.eval, num_epoch=args.epoch)


def visualize_main(args):
    from graphvite_tpu_torch.application import VisualizationApplication

    def load_data(path):
        if path.endswith(".npy"):
            return np.load(path)
        return np.loadtxt(path)

    vectors = load_data(args.file)
    labels = load_data(args.label) if args.label else None
    app = VisualizationApplication(args.dim)
    app.load(vectors=vectors, perplexity=args.perplexity)
    app.build()
    app.train()
    app.visualization(Y=labels, save_file=args.save)


def find_baselines(keywords):
    config_path = get_config_path()
    configs = []
    for path, dirs, files in os.walk(config_path):
        if os.path.basename(path) == "template":
            continue
        for file in files:
            full = os.path.join(path, file)
            if all(re.search(r"[/\\_.]%s[/\\_.]" % re.escape(k), full)
                   for k in keywords):
                configs.append(full)
    return sorted(configs)


def baseline_main(args):
    configs = find_baselines(args.keywords)
    config_path = get_config_path()
    if not configs:
        raise ValueError("no baseline matches keywords: %s"
                         % ", ".join(args.keywords))
    if len(configs) > 1:
        rel = [os.path.relpath(c, config_path) for c in configs]
        raise ValueError("ambiguous keywords; candidates:\n    %s"
                         % "\n    ".join(rel))
    print("running baseline: %s" % os.path.relpath(configs[0], config_path))
    cfg = load_config(configs[0])
    run_config(cfg, do_eval=args.eval, num_epoch=args.epoch)


def list_main(args):
    config_path = get_config_path()
    print("list of baselines\n")
    indent = " " * 4
    count = 0
    for path, dirs, files in sorted(os.walk(config_path)):
        rel = os.path.relpath(path, config_path)
        if rel == "template" or not files:
            continue
        depth = 0 if rel == "." else rel.count(os.sep) + 1
        if rel != ".":
            print(indent * depth + os.path.basename(rel))
        for f in sorted(files):
            print(indent * (depth + 1) + f)
        count += len(files)
        print()
    print("total: %d baselines" % count)


def get_parser():
    parser = argparse.ArgumentParser(
        prog="graphvite_tpu_torch",
        description="graph embedding at high speed and scale, on NVIDIA "
                    "GPUs")
    command = parser.add_subparsers(dest="command", required=True)

    new = command.add_parser("new", help="create a configuration template")
    new.add_argument("application", nargs="+",
                     help="application type (graph | word graph | "
                          "knowledge graph | visualization)")
    new.add_argument("--file", help="output file name")
    new.add_argument("--force", action="store_true",
                     help="overwrite existing file")

    run = command.add_parser("run", help="run from a configuration file")
    run.add_argument("config", help="yaml configuration file")
    run.add_argument("--no-eval", dest="eval", action="store_false",
                     help="turn off evaluation")
    run.add_argument("--epoch", type=int, help="override number of epochs")

    vis = command.add_parser("visualize",
                             help="visualize high-dimensional vectors")
    vis.add_argument("file", help="data file (numpy dump or txt)")
    vis.add_argument("--label", help="label file (numpy dump or txt)")
    vis.add_argument("--save", help="png or pdf file to save")
    vis.add_argument("--perplexity", type=float, default=30)
    vis.add_argument("--3d", dest="dim", action="store_const", const=3,
                     default=2, help="3d plot")

    baseline = command.add_parser("baseline",
                                  help="reproduce baseline benchmarks")
    baseline.add_argument("keywords", metavar="keyword", nargs="+",
                          help="any keyword of the baseline")
    baseline.add_argument("--no-eval", dest="eval", action="store_false")
    baseline.add_argument("--epoch", type=int)

    command.add_parser("list", help="list available baselines")
    return parser


COMMANDS = {
    "new": new_main,
    "run": run_main,
    "visualize": visualize_main,
    "baseline": baseline_main,
    "list": list_main,
}


def main(argv=None):
    args = get_parser().parse_args(argv)
    COMMANDS[args.command](args)


if __name__ == "__main__":
    main()
