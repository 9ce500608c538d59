"""Useful FLOPs of the window's steps (yardstick.train_step_flops: 3x the
forward in full fine-tuning, 2x with adapters, remat excluded) over the
window (the --trace 1 run's untraced part) and the bf16 peak, %."""
from portbench import yardstick as Y


def read(w):
    if not w.steps or w.window_s <= 0:
        return None
    flops = Y.train_step_flops(w.n, w.batch, w.label_len, w.mode) * w.steps
    return 100.0 * flops / w.window_s / Y.PEAK_BF16
