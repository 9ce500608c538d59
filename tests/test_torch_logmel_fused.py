"""Port parity for the fused log-mel frontend (ops/logmel_fused.py, the
counterpart of the Pallas `log_mel_pallas`): its plain version, the CPU path
of the CUDA kernel's wrapper, against the JAX Pallas kernel in interpret
mode, at tests/test_logmel_pallas.py's atol 1e-4."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.ops import logmel_pallas as JLP
from asr_finetune_tpu_torch.ops import logmel as TLM
from asr_finetune_tpu_torch.ops import logmel_fused as TLF


def _audio(seed, B=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, TLM.CHUNK_SAMPLES)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_fused_plain_matches_jax_pallas(n_mels):
    """B 1 at the released models' 80 and 128 mel bins."""
    audio = _audio(n_mels)
    ref = np.asarray(JLP.log_mel_pallas(jnp.asarray(audio), n_mels, interpret=True))
    out = TLF.log_mel_fused_plain(torch.from_numpy(audio), n_mels)
    assert out.shape == ref.shape == (1, 3000, n_mels) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version_and_the_production_form():
    """On a CPU tensor the wrapper runs the plain version; the function is
    the production conv form's (ops/logmel.log_mel_spectrogram), within the
    sum-order differences of fp32; silence floors at the global max − 8."""
    audio = torch.from_numpy(_audio(3, B=2))
    audio[1, :200_000] = 0.0
    out = TLF.log_mel_fused(audio, 80)
    torch.testing.assert_close(out, TLF.log_mel_fused_plain(audio, 80), rtol=0, atol=0)
    torch.testing.assert_close(out, TLM.log_mel_spectrogram(audio, 80), rtol=0, atol=1e-5)
    raw = TLF.log10_mel_plain(audio, 80)
    assert float(out[1, :1000].min()) == pytest.approx(
        (float(raw[1].max()) - 8.0 + 4.0) / 4.0)


def test_no_entry_point_calls_it():
    """Like log_mel_pallas in the JAX package, the fused frontend is a public
    function on no path: no other module of the port imports it."""
    pkg = pathlib.Path(TLF.__file__).resolve().parents[1]
    users = [p for p in pkg.rglob("*.py")
             if "logmel_fused" in p.read_text() and p.name != "logmel_fused.py"]
    assert users == []


# The CUDA kernel's factorisation, run in numpy with the wrapper's tables:
# pass 1 (radix 8, Ns 1), passes 2 and 3 (radix 5, Ns 8 and 40) by
# stage_maps and fft_table, then the real split to the 201 bins, with the
# butterflies written as csrc/logmel.cu writes them.

def _cplx(t, at, n):
    return t[at:at + 2 * n:2] + 1j * t[at + 1:at + 2 * n:2]


def _dft4(a):
    s0, d0, s1, d1 = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
    return [s0 + s1, d0 - 1j * d1, s0 - s1, d0 + 1j * d1]


def _dft8(v, r2):
    e, o = _dft4(v[0::2]), _dft4(v[1::2])
    o[1] = r2 * (o[1].real + o[1].imag) + 1j * r2 * (o[1].imag - o[1].real)
    o[2] = -1j * o[2]
    o[3] = r2 * (o[3].imag - o[3].real) - 1j * r2 * (o[3].real + o[3].imag)
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def _dft5(v, c1, c2, s1, s2):
    a1, b1, a2, b2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
    t1, t2 = v[0] + c1 * a1 + c2 * a2, v[0] + c2 * a1 + c1 * a2
    u1, u2 = s1 * b1 + s2 * b2, s2 * b1 - s1 * b2
    return [v[0] + (a1 + a2), t1 - 1j * u1, t2 - 1j * u2, t2 + 1j * u2, t1 + 1j * u1]


def _kernel_rfft(frames, dtype):
    """(..., 400) frames → (..., 201) spectrum of the windowed frames, by
    the kernel's steps in `dtype` (float64, or float32 with complex64)."""
    ct = np.complex128 if dtype == np.float64 else np.complex64
    t = TLF.fft_table(dtype)
    xw = frames.astype(dtype) * t[TLF.T_WIN:TLF.T_WIN + TLF.N_FFT]
    z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(ct)
    for (r, ns), at in zip(TLF._passes(), TLF._twiddle_offsets()):
        src, dst, _ = TLF.stage_maps(r, ns)
        v = [z[..., src[:, s]] for s in range(r)]
        if at is not None:
            tw = _cplx(t, at, ns * (r - 1)).astype(ct).reshape(ns, r - 1)
            q = np.arange(TLF.NZ // r) % ns
            v = [v[0]] + [v[s] * tw[q, s - 1] for s in range(1, r)]
        v = _dft8(v, t[4]) if r == 8 else _dft5(v, *t[:4])
        z = np.empty_like(z)
        for s in range(r):
            z[..., dst[:, s]] = v[s]
    k = np.arange(TLF.N_PAIRS)
    zk, zc = z[..., k], np.conj(z[..., (TLF.NZ - k) % TLF.NZ])
    e, o = (zk + zc) * 0.5, -1j * (zk - zc) * 0.5
    w = _cplx(t, TLF.T_SPLIT, TLF.N_PAIRS).astype(ct) * o
    X = np.empty(frames.shape[:-1] + (TLF.N_BINS,), ct)
    X[..., k] = e + w
    X[..., TLF.NZ - k[:-1]] = np.conj(e - w)[..., :-1]
    return X


def _frames(audio):
    x = np.pad(audio.astype(np.float64), ((0, 0), (200, 200)), mode="reflect")
    return np.lib.stride_tricks.sliding_window_view(x, 400, axis=-1)[:, ::160][:, :3000]


def test_kernel_factorisation_is_the_rfft_in_fp64():
    """The three passes and the real split with the wrapper's twiddles,
    window and index maps are the real DFT of the windowed frames: equal to
    np.fft.rfft to 1e-10 in fp64 (B 1, 3000 frames, the reflected ends
    included)."""
    frames = _frames(_audio(5))
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(400) / 400))
    ref = np.fft.rfft(frames * w, axis=-1)
    np.testing.assert_allclose(_kernel_rfft(frames, np.float64), ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_steps_in_fp32_match_the_plain_version(n_mels):
    """The kernel's steps in fp32 (the FFT, the powers, the band sums in
    ascending k, log10, the floor) against log_mel_fused_plain within
    chip_smoke.py's fp32 limits: |err| <= 1e-4 + 1e-4 |ref|, RMS(err) <=
    1e-5 RMS(ref); one utterance part silence."""
    audio = _audio(11, B=2)
    audio[1, 100_000:300_000] = 0.0
    X = _kernel_rfft(_frames(audio), np.float32)
    p = X.real * X.real + X.imag * X.imag
    idx, vals = TLF.mel_bands(n_mels)
    mel = np.zeros(p.shape[:-1] + (n_mels,), np.float32)
    for m in range(n_mels):
        lo, a, z = idx[m], idx[n_mels + m], idx[n_mels + m + 1]
        for t in range(a, z):
            mel[..., m] += p[..., lo + t - a] * vals[t]
    out = TLF._normalize(torch.from_numpy(np.log10(np.maximum(mel, np.float32(1e-10)))))
    ref = TLF.log_mel_fused_plain(torch.from_numpy(audio), n_mels)
    diff = (out - ref).abs()
    assert bool((diff <= 1e-4 + 1e-4 * ref.abs()).all()), float(diff.max())
    assert float(diff.square().mean().sqrt() / ref.square().mean().sqrt()) <= 1e-5


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_cover_the_bank_and_sum_as_the_dense_product(n_mels):
    """Every nonzero of mel_filter_bank lies in its mel's band with its
    value; the band sum in ascending k equals the dense sum in ascending k
    bit for bit (the skipped terms are exact zeros)."""
    fb = TLF.mel_filter_bank(n_mels=n_mels)
    idx, vals = TLF.mel_bands(n_mels)
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        lo, a, z = idx[m], idx[n_mels + m], idx[n_mels + m + 1]
        dense[lo:lo + z - a, m] = vals[a:z]
    np.testing.assert_array_equal(dense, fb)
    assert idx[2 * n_mels] == np.count_nonzero(fb) == vals.size
    rng = np.random.default_rng(n_mels)
    p = (rng.standard_exponential((64, TLF.N_BINS)) * 10.0 ** rng.uniform(-6, 2, (64, 1)))
    p = p.astype(np.float32)
    band = np.zeros((64, n_mels), np.float32)
    full = np.zeros((64, n_mels), np.float32)
    for m in range(n_mels):
        lo, a, z = idx[m], idx[n_mels + m], idx[n_mels + m + 1]
        for t in range(a, z):
            band[:, m] += p[:, lo + t - a] * vals[t]
    for k in range(TLF.N_BINS):
        full += p[:, k:k + 1] * fb[k]
    np.testing.assert_array_equal(band, full)


def _ordered(x):
    """csrc/logmel.cu's order-preserving integer image of a float."""
    i = x.view(np.int32)
    return np.where(i >= 0, i, i ^ np.int32(0x7FFFFFFF))


def test_floor_operations_equal_normalize_bit_for_bit():
    """The kernel's floor, run in fp32: the max of the raw values through
    their order-preserving integer images, y = (x + 4) / 4 stored by the
    first launch, and max(y, ((max - 8) + 4) / 4) where a frame block's raw
    minimum lies under max - 8: _normalize's bits, on seeded raw values of
    both signs (one utterance part floored)."""
    rng = np.random.default_rng(4)
    raw = (rng.standard_normal((3, 3000, 80)) * 3.0 - 2.0).astype(np.float32)
    raw[2, 500:1500] = -10.0
    keys = _ordered(raw.reshape(3, -1)).max(axis=1)
    mx = np.where(keys >= 0, keys, keys ^ np.int32(0x7FFFFFFF)).astype(np.int32).view(np.float32)
    np.testing.assert_array_equal(mx, raw.max(axis=(1, 2)))
    x, m = torch.from_numpy(raw), torch.from_numpy(mx)[:, None, None]
    y = (x + 4.0) / 4.0
    c = m - 8.0
    blocks = x.reshape(3, 750, 4 * 80)
    low = (blocks.amin(dim=2, keepdim=True) < c.reshape(3, 1, 1)).expand_as(blocks)
    y = torch.where(low.reshape(x.shape), torch.maximum(y, (c + 4.0) / 4.0), y)
    assert torch.equal(y, TLF._normalize(x))


def test_flops_per_frame_counts_the_fast_transform():
    """The operations the bound is reckoned from: the 400 x 402 dense DFT
    and 201 x n_mels dense mel product take ~30x more."""
    for n_mels in (80, 128):
        dense = 400 * 402 * 2 + 201 * n_mels * 2
        assert 25 < dense / TLF.flops_per_frame(n_mels) < 35


@pytest.mark.parametrize("fn", ["log_mel_spectrogram", "log10_mel_plain"])
def test_production_tables_stay_on_the_device(monkeypatch, fn):
    """The production log-mel and the plain version take their DFT matrix
    and filter bank from a cache per (n_mels, device): the output equals,
    bit for bit, that with tables built afresh, and a second call builds no
    table tensor."""
    audio = torch.from_numpy(_audio(2))
    call = getattr(TLM, fn) if fn == "log_mel_spectrogram" else getattr(TLF, fn)
    out = call(audio, n_mels=80)
    dft = torch.from_numpy(TLM._dft_mat(TLM.N_FFT))
    fb = torch.from_numpy(TLM.mel_filter_bank(n_mels=80))
    frames = torch.nn.functional.pad(audio[:, None], (200, 200), mode="reflect")[:, 0]
    y = torch.matmul(frames.unfold(-1, 400, 160)[:, :3000], dft)
    mel = torch.matmul(y[..., :201] * y[..., :201] + y[..., 201:] * y[..., 201:], fb)
    raw = torch.log10(torch.clamp(mel, min=1e-10))
    ref = TLF._normalize(raw) if fn == "log_mel_spectrogram" else raw
    assert torch.equal(out, ref)

    def no_upload(*args, **kwargs):
        raise AssertionError("a table was built again")
    monkeypatch.setattr(torch, "from_numpy", no_upload)
    assert torch.equal(call(audio, n_mels=80), out)
