"""Device kernels of the traced call per batch it trained."""


def read(ctx):
    if not ctx.batches or not ctx.summary["kernels"]:
        return None
    return ctx.summary["kernels"] / ctx.batches
