"""The remat save points of the port (ASR_TPU_REMAT_SAVE, models/whisper.py):
what each mode keeps for the backward, counted on a forward of a small
model on the CPU, and the switch's values. That the modes change no loss or
gradient bit, full fine-tuning and PEFT: tests/test_torch_train_step.py
::test_remat_changes_no_gradient; on the fused-qkv encoder path: here."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig

# 64-dim heads (the fused-qkv kernel's), 150 encoder frames, 12 labels
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)
B, T_MEL, T_DEC = 4, 300, 12


@pytest.fixture(scope="module")
def model():
    cfg = WhisperConfig(**SMALL)
    params = TW.init_params(cfg, seed=3)
    for _, p in _tensors(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((B, T_MEL, 16)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, 289, (B, T_DEC)))
    return cfg, params, mel, tok


def _tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _kept_bytes(monkeypatch, model, mode) -> int:
    """Bytes the forward keeps for the backward beyond the parameters: the
    distinct storages autograd packs outside any checkpoint
    (saved_tensors_hooks) and those a checkpoint holds through its
    arguments."""
    cfg, params, mel, tok = model
    monkeypatch.setenv("ASR_TPU_REMAT_SAVE", mode)
    skip = {p.untyped_storage().data_ptr() for _, p in _tensors(params)}
    kept = {}

    def note(t):
        if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in skip:
            kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()

    def pack(t):
        note(t)
        return t

    def held(a):
        """Every tensor an argument holds: in containers, in a partial's
        arguments, in a dataclass's fields (a half's parts)."""
        if isinstance(a, torch.Tensor):
            note(a)
        elif isinstance(a, (tuple, list)):
            for x in a:
                held(x)
        elif isinstance(a, dict):
            held(list(a.values()))
        elif isinstance(a, functools.partial):
            held(list(a.args) + list(a.keywords.values()))
        elif dataclasses.is_dataclass(a):
            held([getattr(a, f.name) for f in dataclasses.fields(a)])

    real = TW.checkpoint

    def checkpoint(fn, *args, **kwargs):
        held(args)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(TW, "checkpoint", checkpoint)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TW.forward(params, mel, tok, cfg, torch.float32, remat=True,
                         decoder_attn_impl="xla", return_hidden=True)
    out.sum().backward()
    return sum(kept.values())


def test_save_points_keep_what_they_name(model, monkeypatch):
    """mid < enc < enc+dec. enc adds, per encoder layer and row, q, k, v,
    fc1's output and the two layer-norm outputs the products' backward
    reads (3d + ff + 2d); enc+dec adds per decoder layer the self-attention's
    q/k/v, the cross-attention's q, the MLP's fc1 output and three layer-norm
    outputs at each label row, and the cross-attention's k/v at each encoder
    row, all fp32 here."""
    cfg = model[0]
    d, ff, L_e, L_d = cfg.d_model, cfg.d_ff, cfg.encoder_layers, cfg.decoder_layers
    t_enc = T_MEL // 2
    got = {m: _kept_bytes(monkeypatch, model, m) for m in TW.REMAT_SAVES}
    assert got["mid"] < got["enc"] < got["enc+dec"]
    assert got["enc"] - got["mid"] == 4 * L_e * B * t_enc * (3 * d + ff + 2 * d)
    assert got["enc+dec"] - got["enc"] == 4 * L_d * B * (
        T_DEC * (3 * d + d + ff + 3 * d) + t_enc * 2 * d)


def test_unknown_save_mode_raises(model, monkeypatch):
    """JAX takes any other value for "mid"; the port refuses it, as its
    other switches do. Without remat (and without autograd) it is not read."""
    cfg, params, mel, tok = model
    monkeypatch.setenv("ASR_TPU_REMAT_SAVE", "bogus")
    with pytest.raises(ValueError, match="ASR_TPU_REMAT_SAVE"):
        TW.forward(params, mel, tok, cfg, torch.float32, remat=True)
    with pytest.raises(ValueError, match="ASR_TPU_REMAT_SAVE"):
        TW.remat_save()
    with torch.no_grad():
        TW.forward(params, mel, tok, cfg, torch.float32, remat=True)
    monkeypatch.delenv("ASR_TPU_REMAT_SAVE")
    assert TW.remat_save() == "enc+dec"           # the JAX default


@pytest.mark.parametrize("mode", ["mid", "enc"])
def test_fused_qkv_save_point_changes_no_bit(model, monkeypatch, mode):
    """On the fused-qkv encoder path `enc` keeps the one (B, T, 3d) buffer:
    the encoder output's gradients equal those without remat bit for bit."""
    cfg, params, mel, tok = model
    monkeypatch.setenv("ASR_TPU_FUSED_QKV", "force")
    monkeypatch.setenv("ASR_TPU_REMAT_SAVE", mode)
    leaves = [p for _, p in _tensors(params["encoder"])]

    def grads(remat):
        for p in leaves:
            p.grad = None
        out = TW.encode(params, mel, cfg, torch.float32, remat=remat)
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        return [p.grad.clone() for p in leaves]

    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
