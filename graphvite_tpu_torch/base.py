"""Global user configuration and default types (the port of
graphvite_tpu/base.py).

Reads ``~/.graphvite_tpu/config.yaml`` once at import, through the port's
own YAML reader (`utils/yaml_lite.py`: the card's host has no pyyaml):

    dataset_path: ~/my_datasets
    float_type: float32       # float32 | float64 | bfloat16
    index_type: int32
    backend: graphvite        # evaluation backend name, kept for parity

Values are exposed as module attributes and used as defaults by
`graphvite_tpu_torch.dataset` (dataset_path) and the applications
(dtypes). bfloat16 maps straight to `torch.bfloat16`: the port needs no
ml_dtypes. The environment variable GRAPHVITE_DATASET_PATH wins over the
file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from graphvite_tpu_torch.utils import yaml_lite
from graphvite_tpu_torch.utils.common import assert_in, logger

CONFIG_FILE = os.path.expanduser("~/.graphvite_tpu/config.yaml")

dataset_path = os.path.expanduser("~/.graphvite_tpu/dataset")
float_type = torch.float32
index_type = torch.int32
backend = "graphvite"

_FLOAT_TYPES = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16}
_INDEX_TYPES = {"uint32": torch.int32, "int32": torch.int32,
                "uint64": torch.int64, "int64": torch.int64}


def load_global_config():
    global dataset_path, float_type, index_type, backend
    if not os.path.isfile(CONFIG_FILE):
        return
    try:
        cfg = yaml_lite.load_file(CONFIG_FILE) or {}
    except Exception as e:  # pragma: no cover
        logger.warning("cannot read %s: %s", CONFIG_FILE, e)
        return
    if "dataset_path" in cfg:
        dataset_path = os.path.expanduser(str(cfg["dataset_path"]))
    if "float_type" in cfg:
        float_type = _FLOAT_TYPES.get(str(cfg["float_type"]), float_type)
    if "index_type" in cfg:
        index_type = _INDEX_TYPES.get(str(cfg["index_type"]), index_type)
    if "backend" in cfg:
        backend = str(cfg["backend"])


def torch_float_type(value):
    """torch dtype for a float type given as a torch dtype, a name
    ("bfloat16"), or a numpy dtype (including ml_dtypes' bfloat16, whose
    dtype name is "bfloat16")."""
    if value is None:
        return float_type
    if isinstance(value, torch.dtype):
        return value
    name = value if isinstance(value, str) else np.dtype(value).name
    assert_in("float type", name, _FLOAT_TYPES)
    return _FLOAT_TYPES[name]


load_global_config()
if "GRAPHVITE_DATASET_PATH" in os.environ:
    dataset_path = os.environ["GRAPHVITE_DATASET_PATH"]
