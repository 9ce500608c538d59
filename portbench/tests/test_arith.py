"""The frozen FLOP and byte arithmetic of the benchmark's yardstick."""
import itertools
import json
import os

import pytest

from portbench import weights as WT
from portbench import yardstick as Y

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dims(name):
    return WT.dims(json.load(open(os.path.join(ROOT, "portbench", "configs", name + ".json"))))


def _forward(d, ff, L_e, L_d, mels, V, T, S=1500, frames=3000):
    """A Whisper forward's matmul FLOPs for one utterance, written out
    product by product."""
    stem = 2 * frames * 3 * mels * d + 2 * S * 3 * d * d
    enc_layer = (2 * S * d * d * 4          # q, k, v, o
                 + 2 * S * S * d * 2        # QK^T and PV
                 + 2 * S * d * ff * 2)      # fc1, fc2
    dec_layer = (2 * T * d * d * 4 + 2 * T * T * d * 2          # self attention
                 + 2 * T * d * d * 2 + 2 * S * d * d * 2        # cross q, o and k, v
                 + 2 * T * S * d * 2 + 2 * T * d * ff * 2)      # cross attention, MLP
    return stem + L_e * enc_layer + L_d * dec_layer + 2 * T * d * V


def test_train_step_flops_large_v3_peft():
    n = _dims("whisper-large-v3")
    want = 2 * _forward(1280, 5120, 32, 32, 128, 51866, 192)
    got = Y.train_step_flops(n, 1, 192, "peft")
    assert got == pytest.approx(want, rel=1e-12)
    assert got / 1e12 == pytest.approx(5.898, abs=5e-4)


def test_train_step_flops_small_full():
    n = _dims("whisper-small")
    want = 3 * _forward(768, 3072, 12, 12, 80, 51865, 192)
    got = Y.train_step_flops(n, 1, 192, "full")
    assert got == pytest.approx(want, rel=1e-12)
    assert got / 1e12 == pytest.approx(1.356, abs=5e-4)


@pytest.mark.parametrize("B,H,Tq,Tk", [(4, 20, 1500, 1500), (4, 20, 192, 1500),
                                       (32, 12, 1500, 1500), (1, 1, 8, 16)])
def test_attention_bounds_are_the_work_of_their_shapes(B, H, Tq, Tk):
    hd, e = 64, 2
    fwd_bytes = e * B * H * hd * (Tq + 2 * Tk + Tq) + 4 * B * H * Tq
    fwd_ops = 2 * 2 * B * H * Tq * Tk * hd
    assert Y.attention_fwd_bound(B, H, Tq, Tk, hd) == pytest.approx(
        max(fwd_bytes / Y.HBM_BYTES_PER_S, fwd_ops / Y.PEAK_OPS["bfloat16"]))
    bwd_bytes = e * B * H * hd * (Tq + 2 * Tk + Tq + Tq + 2 * Tk) + 4 * B * H * Tq
    bwd_ops = 5 * 2 * B * H * Tq * Tk * hd
    assert Y.attention_bwd_bound(B, H, Tq, Tk, hd) == pytest.approx(
        max(bwd_bytes / Y.HBM_BYTES_PER_S, bwd_ops / Y.PEAK_OPS["bfloat16"]))


def test_bounds_match_the_kernel_table():
    """The bound column of PERF.md's kernel table (B 4, large-v3), in ms."""
    assert Y.attention_fwd_bound(4, 20, 1500, 1500, 64) * 1e3 == pytest.approx(0.0466, abs=1e-4)
    assert Y.attention_bwd_bound(4, 20, 1500, 1500, 64) * 1e3 == pytest.approx(0.1165, abs=1e-4)
    assert Y.attention_fwd_bound(4, 20, 192, 1500, 64) * 1e3 == pytest.approx(0.0103, abs=1e-4)
    assert Y.attention_bwd_bound(4, 20, 192, 1500, 64) * 1e3 == pytest.approx(0.0201, abs=1e-4)
    assert Y.w8a8_bound(6000, 1280, 1280) * 1e3 == pytest.approx(0.0099, abs=1e-4)
    assert Y.w8a8_bound(6000, 1280, 5120) * 1e3 == pytest.approx(0.0397, abs=1e-4)
    assert Y.w8a8_bound(768, 1280, 1280) * 1e3 == pytest.approx(0.0017, abs=1e-4)


@pytest.mark.parametrize("m,K,N,addend", itertools.product((1, 768, 6000), (1280, 5120),
                                                           (1280, 5120), (False, True)))
def test_w8a8_bound_never_exceeds_its_work(m, K, N, addend):
    nbytes = 2 * m * K + K * N + 4 * N + 2 * m * N + (4 * m * N if addend else 0)
    ops = 2 * m * K * N
    b = Y.w8a8_bound(m, K, N, 2, addend)
    assert b == pytest.approx(max(nbytes / Y.HBM_BYTES_PER_S, ops / Y.PEAK_OPS["int8"]))
    assert b <= nbytes / Y.HBM_BYTES_PER_S + ops / Y.PEAK_OPS["int8"]


@pytest.mark.parametrize("rows,pos", [(32, 0), (32, 126), (4, 63), (1, 447)])
def test_decode_bound_reads_the_weights_and_both_caches(rows, pos):
    n = _dims("whisper-large-v3")
    d, ff, L, S = 1280, 5120, 32, 1500
    weights = 2 * (6 * d * d + 2 * d * ff)
    cache = 2 * rows * 2 * d * (pos + 1)
    cross = 2 * rows * 2 * S * d
    per_layer_bytes = weights + cache + cross
    b = Y.decode_layers_bound(n, rows, pos)
    # the small terms (layer norms, biases, activations) add under 1%
    assert b >= L * per_layer_bytes / Y.HBM_BYTES_PER_S
    assert b <= 1.01 * L * per_layer_bytes / Y.HBM_BYTES_PER_S
    ops = rows * L * (2 * (6 * d * d + 2 * d * ff) + 4 * (pos + 1) * d + 4 * S * d)
    assert ops / Y.PEAK_BF16 <= b


def test_decode_position_flops_count_every_product():
    n = _dims("whisper-large-v3")
    d, ff, L, S, V = 1280, 5120, 32, 1500, 51866
    pos = 10
    want = 32 * (L * (2 * d * d * 6 + 2 * d * ff * 2 + 2 * 2 * (pos + 1) * d
                      + 2 * 2 * S * d) + 2 * d * V)
    assert Y.decode_position_flops(n, 32, pos) == pytest.approx(want)
