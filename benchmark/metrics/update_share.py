"""The row updates' share of the traced call's episodes, in %: device
seconds in the program's `update` spans (from the delta's assembly through
`scatter_add_` / `apply_row_updates`) over those in its `episode` spans."""
from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("update",), "episode", "device_s")
