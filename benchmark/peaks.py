"""The card's published peaks and the roofline arithmetic.

Copied from chip_smoke.py:378-380 (the constants) and 1669-1674
(`bytes_bound`): NVIDIA's data sheet for the H100 SXM at its full 700 W,
dense float32 outside the tensor cores and HBM3 bandwidth. Every share of
these peaks is reported beside the card's power limit (`device` in the
result line), since a card set below 700 W runs slower under load.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(nbytes, ops=0.0, cards=1):
    """(seconds, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 rate, of `cards` cards
    together."""
    t_bytes = nbytes / (HBM_BYTES_PER_S * cards)
    t_ops = ops / (FP32_OPS_PER_S * cards)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
