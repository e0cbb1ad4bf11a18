"""Share of the Restorer's copies between host and card that went through
page-locked memory: 100 x the page-locked copies over all copies counted
in eval/engine.py's ``COPIES`` (one each way a request), over the whole
run; None where the program has no such counter or counted nothing, and
off the card, where nothing is copied."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    from virnet_tpu_torch.eval import engine

    copies = getattr(engine, "COPIES", None)
    total = sum(copies.values()) if copies else 0
    if not total:
        return None
    pinned = copies.get("pinned_in", 0) + copies.get("pinned_out", 0)
    return 100.0 * pinned / total
