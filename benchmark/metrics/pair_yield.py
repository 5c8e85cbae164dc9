"""Useful positives per positive slot in the traced call, in %: the
program's `valid_pairs` counter (the pair flags the steps sum) over its
`pair_slots` counter (the slots the runner hands the steps)."""
from benchmark import spans


def read(ctx):
    return spans.counter_share(ctx, "valid_pairs", "pair_slots")
