"""Useful FLOPs of the window's steps over the window (the --trace 1 run's
untraced part) and the bf16 peak, %: family_unimoe.train_step_flops (2x the
forward with adapters, remat left out), its dynamic experts' part from the
rows the port's counters say they computed a token. None where the program
has no such counters."""
from portbench import yardstick as Y


def read(w):
    c = getattr(w.family, "moe_counts", lambda: None)()
    if not w.steps or w.window_s <= 0 or not c or not c.get("tokens"):
        return None
    rows = c["expert_rows"] / c["tokens"]
    flops = w.family.train_step_flops(w.n, w.batch, w.label_len, w.mode, rows) * w.steps
    return 100.0 * flops / w.window_s / Y.PEAK_BF16
