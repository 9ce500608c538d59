"""The encoder-attention kernels' share of their roofline, %: the bounds of
every forward and backward call in the traced window (remat's recompute
included) over the device time of the enc_attn_fwd* / enc_attn_bwd*
kernels."""
from portbench import yardstick as Y


def read(w):
    if w.trace is None:
        return None
    bound = sum(Y.attention_fwd_bound(*c[1:]) for c in w.calls.of("attn_fwd")) \
        + sum(Y.attention_bwd_bound(*c[1:]) for c in w.calls.of("attn_bwd"))
    dev = w.trace.device_s(lambda k: Y.kernel_category(k) in (Y.ATTN_FWD, Y.ATTN_BWD))
    if bound <= 0 or dev <= 0:
        return None
    return 100.0 * bound / dev
