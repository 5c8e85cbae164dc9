"""The samplers' share of the traced call's episodes, in %: device seconds
in the program's `sample` spans (the positives: walk chain and emission,
or the edge stream) and `negatives` spans (the pool draws) over those in
its `episode` spans."""
from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("sample", "negatives"), "episode", "device_s")
