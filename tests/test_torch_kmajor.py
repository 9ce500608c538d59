"""The K-major (d_out, d_in) copy of every int8 weight, which the W8A8
kernel reads on the card (8-bit wgmma takes only K-major operands), on the
CPU: it equals w_q8's transpose for every stacked weight, the int8 tree
itself stays the JAX tree, the fused-qkv weight and the adapter merge carry
it along, run.build_model makes it once (the products of two forwards read
the same tensors), and a PEFT forward over a base that carries it still
equals the JAX package's (tests/test_torch_peft_cli.py checks it is never
written to an adapter checkpoint)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.ops import quant as JQ
from asr_finetune_tpu.training import lora as JL
from asr_finetune_tpu_torch import config as TCONF
from asr_finetune_tpu_torch import run as TRUN
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import quant as TQ
from asr_finetune_tpu_torch.training import lora as TL

# tests/test_torch_peft.py's SMALL: 64-dim heads, 150 encoder frames
SMALL = dict(vocab_size=300, num_mel_bins=16, d_model=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2, d_ff=256,
             max_source_positions=150, max_target_positions=32,
             eos_token_id=290, sot_token_id=291, translate_token_id=293,
             transcribe_token_id=294, no_timestamps_token_id=295,
             timestamp_begin_id=296, pad_token_id=290, first_language_token_id=292)


def _carry(tree):
    return TIO.params_from_numpy(JIO._flatten(tree), "cpu")


def _int8_leaves(tree, path=""):
    """(path, {w_q8, w_scale[, w_q8_nk]}) of every int8 weight of a tree."""
    if TQ.QUANT_KEY in tree:
        yield path, tree
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _int8_leaves(v, f"{path}/{k}" if path else k)


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(**SMALL)
    jparams = JW.init_params(jax.random.PRNGKey(3), jcfg)
    jq = JQ.quantize_tree_int8(jparams)
    return jcfg, TConfig(**SMALL), jparams, jq


def test_copy_is_the_transpose_of_every_stacked_weight(small):
    """add_k_major_copies puts beside every stacked w_q8 (L, d_in, d_out) a
    contiguous int8 (L, d_out, d_in) equal to its transpose, shares every
    other leaf, and quantize_tree_int8 alone still gives the JAX tree."""
    _, _, jparams, jq = small
    tq = TQ.quantize_tree_int8(_carry(jparams))
    assert set(TIO.params_to_numpy(tq)) == set(JIO._flatten(jq))
    with_copies = TQ.add_k_major_copies(tq)
    leaves = list(_int8_leaves(with_copies))
    assert len(leaves) == 6 + 10   # encoder q/k/v/o/fc1/fc2; decoder self, cross, fc1, fc2
    for path, p in leaves:
        nk = p[TQ.KMAJOR_KEY]
        assert nk.dtype == torch.int8 and nk.is_contiguous(), path
        assert nk.shape == p[TQ.QUANT_KEY].transpose(-1, -2).shape, path
        assert torch.equal(nk, p[TQ.QUANT_KEY].transpose(-1, -2)), path
    assert with_copies["encoder"]["conv1"]["w"] is tq["encoder"]["conv1"]["w"]
    # a second pass adds nothing: the copies are made once
    again = TQ.add_k_major_copies(with_copies)
    for (_, a), (_, b) in zip(_int8_leaves(again), leaves):
        assert a[TQ.KMAJOR_KEY] is b[TQ.KMAJOR_KEY]


def test_fused_qkv_and_merge_carry_the_copy(small):
    """The fused-qkv wide weight's copy is the copies of q, k and v along
    d_out, the transpose of the fused w_q8; merging adapters into q and v
    drops their int8 leaves with the copy, k keeps its copy."""
    jcfg, _, _, jq = small
    tq = TQ.add_k_major_copies(_carry(jq))
    attn = tq["encoder"]["layers"]["attn"]
    fused = TW._fuse_qkv_weights(attn)
    assert torch.equal(fused[TQ.KMAJOR_KEY], fused[TQ.QUANT_KEY].transpose(-1, -2))
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg, JL.LoraConfig(rank=4, alpha=8.0),
                           encoder=True)
    merged = TL.merge_adapters(tq, _carry(jad))
    m_attn = merged["encoder"]["layers"]["attn"]
    assert set(m_attn["q"]) == {"w", "b"} and set(m_attn["v"]) == {"w", "b"}
    assert m_attn["k"][TQ.KMAJOR_KEY] is attn["k"][TQ.KMAJOR_KEY]


def test_build_model_makes_the_copies_once(small, tmp_path, monkeypatch):
    """run.build_model --peft --load_in_8bit --int8_matmul gives every int8
    weight its copy (without --int8_matmul, none); two forwards through
    W8A8 hand the product the same tensors, views of the built copies."""
    base = ["--model_type", "test-nano", "--device", "cpu", "--peft", "--load_in_8bit",
            "--output_dir", str(tmp_path)]
    plain = TRUN.build_model(TCONF.parse_args(base), train=True)
    assert all(TQ.KMAJOR_KEY not in p for _, p in _int8_leaves(plain.params))
    built = TRUN.build_model(TCONF.parse_args(base + ["--int8_matmul"]), train=True)
    leaves = list(_int8_leaves(built.params))
    assert leaves and all(torch.equal(p[TQ.KMAJOR_KEY], p[TQ.QUANT_KEY].transpose(-1, -2))
                          for _, p in leaves)
    storages = {p[TQ.KMAJOR_KEY].untyped_storage().data_ptr() for _, p in leaves}

    seen = []
    real = TQ.w8a8

    def spy(x, w_q8, w_scale, keep=None, addend=None, w_nk=None):
        seen.append(None if w_nk is None else (w_nk.untyped_storage().data_ptr(),
                                               w_nk.storage_offset(), tuple(w_nk.shape)))
        return real(x, w_q8, w_scale, keep, addend, w_nk)

    monkeypatch.setattr(TQ, "w8a8", spy)
    cfg = built.cfg
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (2, 2 * cfg.max_source_positions, cfg.num_mel_bins)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 250, (2, 6))).long()
    quant = TQ.QuantConfig(matmul=True)
    calls = []
    for _ in range(2):
        seen.clear()
        with torch.no_grad():
            TW.forward(built.params, mel, toks, cfg, torch.float32,
                       decoder_attn_impl="xla", quant=quant)
        calls.append(list(seen))
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    assert len(calls[0]) == 6 * n_enc + 10 * n_dec
    assert calls[0] == calls[1]
    assert all(c is not None and c[0] in storages for c in calls[0])


@pytest.fixture
def jax_int8_compute():
    yield JQ
    JQ.set_int8_compute(False)
    JQ.set_int8_outlier_cols(0)


def test_peft_forward_over_the_copies_matches_jax(small, jax_int8_compute):
    """The W8A8 forward with encoder and decoder adapters over an int8 base
    that carries the copies: equal to the forward without them (the plain
    version reads w_q8), and to JAX `W.forward` within the W8A8 forward's
    tolerance of tests/test_torch_peft.py (2e-2: fp32 activations differ
    in the last bits between the frameworks and flip an int8 rounding now
    and then)."""
    jcfg, tcfg, _, jq = small
    jad = JL.init_adapters(jax.random.PRNGKey(4), jcfg, JL.LoraConfig(rank=4, alpha=8.0),
                           encoder=True)
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 300, 16)).astype(np.float32)
    toks = rng.integers(0, 289, (2, 10)).astype(np.int32)
    JQ.set_int8_compute(True)
    JQ.set_int8_outlier_cols(2)
    ref = jax.jit(lambda p, a, m, t: JW.forward(
        p, m, t, jcfg, adapters=a, compute_dtype=jnp.float32,
        decoder_attn_impl="xla"))(jq, jad, jnp.asarray(mel), jnp.asarray(toks))
    tbase = _carry(jq)
    quant = TQ.QuantConfig(matmul=True, outlier_cols=2)
    outs = [TW.forward(base, torch.from_numpy(mel), torch.from_numpy(toks).long(), tcfg,
                       torch.float32, decoder_attn_impl="xla", adapters=_carry(jad),
                       quant=quant)
            for base in (TQ.add_k_major_copies(tbase), tbase)]
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), rtol=0, atol=2e-2)
