"""The exchange's share of the walks engine's episodes, in %: on each
card, device seconds in the program's `mesh::*` spans (the collectives
between the workers, one span a card each) over those in its `episode`
spans on that card; the mean over the cards. None where the program has
no span of either kind per card (one card, or no engine)."""
from benchmark import spans


def read(ctx):
    s = spans.session(ctx)
    if s is None:
        return None
    episode = spans._tracing().PREFIX + "episode"
    mesh, whole = {}, {}
    for sp in s["raw"]:
        if sp.device is None or sp.device_s is None:
            continue
        card = str(sp.device)
        if sp.name.startswith("mesh::"):
            mesh[card] = mesh.get(card, 0.0) + sp.device_s
        elif sp.name == episode:
            whole[card] = whole.get(card, 0.0) + sp.device_s
    cards = [c for c in whole if whole[c] > 0 and c in mesh]
    if not cards:
        return None
    shares = {c: 100.0 * mesh[c] / whole[c] for c in sorted(cards)}
    ctx.detail["exchange_share_by_card"] = shares
    return sum(shares.values()) / len(shares)
