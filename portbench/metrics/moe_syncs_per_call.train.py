"""Host syncs of the expert layers a layer call, over the run: the port's
counters (models/unimoe.moe_counters), count_syncs over layer_calls. A call
reads its experts' row counts once (1); a grouped product with offsets on
the card would take none. None where the program has no such counters."""


def read(w):
    c = getattr(w.family, "moe_counts", lambda: None)()
    if not c or not c.get("layer_calls"):
        return None
    return c["count_syncs"] / c["layer_calls"]
