"""Dynamic-expert rows computed a token routed, over the run: the port's
expert-layer counters (models/unimoe.moe_counters, through the family's
moe_counts), expert_rows over tokens; remat's recomputes count in both.
Fixed by the weights and the traffic: it moves only with the routing.
None where the program has no such counters."""


def read(w):
    c = getattr(w.family, "moe_counts", lambda: None)()
    if not c or not c.get("tokens"):
        return None
    return c["expert_rows"] / c["tokens"]
