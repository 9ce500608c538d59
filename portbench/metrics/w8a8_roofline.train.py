"""The W8A8 kernels' share of their roofline, %: the bounds of every W8A8
product with its row quantisation in the traced window over the device
time of the quantize_rows / w8a8 kernels."""
from portbench import yardstick as Y


def read(w):
    if w.trace is None:
        return None
    bound = sum(Y.w8a8_bound(m, K, N, e, a) for _, m, K, N, e, a in w.calls.of("w8a8"))
    dev = w.trace.device_s(lambda k: Y.kernel_category(k) == Y.W8A8)
    if bound <= 0 or dev <= 0:
        return None
    return 100.0 * bound / dev
