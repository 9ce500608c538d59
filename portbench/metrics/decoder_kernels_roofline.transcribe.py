"""The fused decoder kernels' share of their roofline, %: the bound of
every layer's fused calls at every decode position of the traced window
(yardstick.decode_layers_bound) over the device time of the decoder
kernels (qkv, attn_q / attn_chunk / attn_wo, mlp_fc1 / mlp_fc2)."""
from portbench import yardstick as Y


def read(w):
    if w.trace is None or not w.positions:
        return None
    bound = sum(Y.decode_layers_bound(w.n, w.batch, p)
                for steps in w.positions for p in range(steps))
    dev = w.trace.device_s(lambda k: Y.kernel_category(k) == Y.DECODER)
    if dev <= 0:
        return None
    return 100.0 * bound / dev
