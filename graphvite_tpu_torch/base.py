"""Default float and index types (the port's copy of graphvite_tpu/base.py).

bfloat16 maps straight to `torch.bfloat16`: the port needs no ml_dtypes.
The reference's optional ~/.graphvite_tpu/config.yaml is not read here
(the card's host has no pyyaml); pass dtypes to the solver instead.
"""
from __future__ import annotations

import numpy as np
import torch

from graphvite_tpu_torch.utils.common import assert_in

float_type = torch.float32
index_type = torch.int32

_FLOAT_TYPES = {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16}


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
