"""Device idle share of the traced call: 1 minus the union of device
kernel, copy and set intervals over the call's wall time, in %; on a cell
of several cards, the mean over the cards of each card's union."""


def read(ctx):
    s = ctx.summary
    if s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
