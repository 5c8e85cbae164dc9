"""The share of the traced call spent around its episodes, in %: host
seconds in the program's `prepare` (entry to the first episode: the
negative alias table, the step, the sampler) and `finish` (last episode to
return) spans over those in its `train` span."""
from benchmark import spans


def read(ctx):
    return spans.share(ctx, ("prepare", "finish"), "train", "host_s")
