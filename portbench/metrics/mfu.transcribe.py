"""Useful FLOPs of the window's batches over the window (the --trace 1
run's untraced part) and the bf16 peak, %: the encoder forward, the cross
K/V projections once per utterance, and at every decode position the
decoder layers and the logits (log-mel left out)."""
from portbench import yardstick as Y


def read(w):
    if not w.positions_window or w.window_s <= 0:
        return None
    flops = 0.0
    for steps in w.positions_window:
        flops += Y.encoder_flops(w.n, w.batch) + Y.cross_kv_flops(w.n, w.batch)
        flops += sum(Y.decode_position_flops(w.n, w.batch, p) for p in range(steps))
    return 100.0 * flops / w.window_s / Y.PEAK_BF16
