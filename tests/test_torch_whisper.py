"""Port parity: asr_finetune_tpu_torch models (weight carry, HF import,
log-mel, encoder, decode steps) against the JAX package, at fp32 on CPU.

The JAX model's parameters reach the port through params_from_numpy, so both
sides run the same weights; the inputs come from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_finetune_tpu.models import native_io as JIO
from asr_finetune_tpu.models import whisper as JW
from asr_finetune_tpu.models.configs import WhisperConfig as JConfig
from asr_finetune_tpu.ops import logmel as JLM
from asr_finetune_tpu_torch.models import native_io as TIO
from asr_finetune_tpu_torch.models import whisper as TW
from asr_finetune_tpu_torch.models.configs import WhisperConfig as TConfig
from asr_finetune_tpu_torch.ops import logmel as TLM

TINY = dict(vocab_size=613, num_mel_bins=16, d_model=256, encoder_layers=2,
            encoder_heads=4, decoder_layers=2, decoder_heads=4, d_ff=1024,
            max_source_positions=48, max_target_positions=64, eos_token_id=607,
            sot_token_id=608, translate_token_id=609, transcribe_token_id=610,
            no_timestamps_token_id=611, timestamp_begin_id=612, pad_token_id=607,
            first_language_token_id=609)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JConfig(**TINY), TConfig(**TINY)
    jparams = JW.init_params(jax.random.PRNGKey(1), jcfg)
    flat = JIO._flatten(jparams)
    tparams = TIO.params_from_numpy(flat, "cpu")
    mel = np.random.default_rng(2).standard_normal(
        (2, 2 * jcfg.max_source_positions, jcfg.num_mel_bins)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, flat, mel


def test_params_from_numpy_round_trip(tiny):
    *_, tparams, flat, _ = tiny
    back = TIO.params_to_numpy(tparams)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # stacked layouts survive: (L, d_in, d_out) weights, (L, d) biases
    assert tuple(tparams["decoder"]["layers"]["mlp"]["fc1"]["w"].shape) == (2, 256, 1024)
    assert tuple(tparams["decoder"]["layers"]["self_attn"]["q"]["b"].shape) == (2, 256)


def test_params_from_numpy_dtype(tiny):
    *_, flat, _ = tiny
    p = TIO.params_from_numpy(flat, "cpu", torch.bfloat16)
    w = p["encoder"]["layers"]["attn"]["q"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        torch.tensor(flat["encoder/layers/attn/q/w"]).bfloat16().float().numpy())


def test_init_params_layout_matches_jax(tiny):
    jcfg, tcfg, jparams, *_ = tiny
    ours = TIO.params_to_numpy(TW.init_params(tcfg, seed=0))
    ref = JIO._flatten(jparams)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
    np.testing.assert_allclose(ours["encoder_pos"], ref["encoder_pos"], atol=1e-6)


def test_native_checkpoint_loads(tiny, tmp_path):
    jcfg, _, jparams, *_ = tiny
    JIO.save_params(str(tmp_path), jparams, jcfg)
    assert TIO.is_native_checkpoint(str(tmp_path))
    params, cfg = TIO.load_params(str(tmp_path), "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    flat = TIO.params_to_numpy(params)
    for k, v in JIO._flatten(jparams).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_convert_hf_matches_jax(tmp_path):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    from asr_finetune_tpu.models import convert_hf as JHF
    from asr_finetune_tpu_torch.models import convert_hf as THF

    hf_cfg = WhisperConfig(
        vocab_size=120, num_mel_bins=80, d_model=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=150,
        max_target_positions=64, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=3)
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(hf_cfg)
    sd = model.state_dict()
    jcfg, tcfg = JHF.config_from_hf(hf_cfg), THF.config_from_hf(hf_cfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    ref = JIO._flatten(JHF.from_hf_state_dict(sd, jcfg))
    ours = TIO.params_to_numpy(THF.from_hf_state_dict(sd, tcfg))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # and from a checkpoint directory (config.json + weights)
    model.save_pretrained(str(tmp_path))
    params, cfg = THF.load_pretrained(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    loaded = TIO.params_to_numpy(params)
    for k in ref:
        np.testing.assert_array_equal(loaded[k], ref[k], err_msg=k)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_logmel_matches_jax(n_mels):
    rng = np.random.default_rng(n_mels)
    audio = np.stack([
        JLM.pad_or_trim((rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)),
        (rng.standard_normal(16000 * 30) * 0.1).astype(np.float32)])
    ref = np.asarray(JLM.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    ours = TLM.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert ours.shape == ref.shape == (2, 3000, n_mels)
    # both are fp32 DFT products summed in another order; log10 amplifies
    # the rounding where the power is tiny (tests/test_logmel.py), so the
    # max is bounded loosely and the mean tightly
    diff = np.abs(ours - ref)
    assert diff.max() < 1e-2 and diff.mean() < 1e-5, (diff.max(), diff.mean())


def test_encode_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams, _, mel = tiny
    ref = JW.encode(jparams, jnp.asarray(mel), jcfg, compute_dtype=jnp.float32)
    ours = TW.encode(tparams, torch.from_numpy(mel), tcfg, torch.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_cast_matmul_weights_keeps_bf16_encode(tiny):
    """Casting the matmul weights once leaves layer norms and the conv stem
    in fp32 and the bf16 encoder output bit for bit as casting at use."""
    *_, flat, mel = tiny
    params = TIO.params_from_numpy(flat, "cpu")
    cast = TW.cast_matmul_weights_(TIO.params_from_numpy(flat, "cpu"), torch.bfloat16)
    enc, dec = cast["encoder"], cast["decoder"]
    assert enc["layers"]["attn"]["q"]["w"].dtype == torch.bfloat16
    assert dec["layers"]["cross_attn"]["o"]["b"].dtype == torch.bfloat16
    assert dec["embed"].dtype == dec["pos"].dtype == torch.bfloat16
    for ln in (enc["layers"]["ln1"], dec["layers"]["ln3"], enc["ln_post"]):
        assert ln["scale"].dtype == ln["bias"].dtype == torch.float32
    assert enc["conv1"]["w"].dtype == cast["encoder_pos"].dtype == torch.float32
    tcfg = TConfig(**TINY)
    m = torch.from_numpy(mel)
    torch.testing.assert_close(TW.encode(cast, m, tcfg, torch.bfloat16),
                               TW.encode(params, m, tcfg, torch.bfloat16),
                               rtol=0, atol=0)


def _cross_kv(jcfg, tcfg, jparams, tparams, mel):
    enc = JW.encode(jparams, jnp.asarray(mel), jcfg, compute_dtype=jnp.float32)
    jckv = JW.precompute_cross_kv(jparams, enc, jcfg)
    tckv = TW.precompute_cross_kv(tparams, torch.tensor(np.asarray(enc)), tcfg)
    for k in ("k", "v"):
        np.testing.assert_allclose(tckv[k].numpy(), np.asarray(jckv[k]),
                                   rtol=1e-5, atol=1e-5)
    return enc, jckv, tckv


def test_decode_step_matches_jax(tiny):
    """The plain reference step, (L, B, T, H, hd) cache, 4 positions."""
    jcfg, tcfg, jparams, tparams, _, mel = tiny
    enc, jckv, tckv = _cross_kv(jcfg, tcfg, jparams, tparams, mel)
    Bt = mel.shape[0]
    jcache = JW.init_cache(jcfg, Bt, 32, dtype=jnp.float32)
    tcache = TW.init_cache(tcfg, Bt, 32, dtype=torch.float32)
    rng = np.random.default_rng(4)
    for pos in range(4):
        tok = rng.integers(0, jcfg.vocab_size, Bt)
        lj, jcache = JW.decode_step(jparams, jnp.asarray(tok, jnp.int32),
                                    jnp.int32(pos), jcache, jckv, jcfg, None,
                                    jnp.float32)
        lt, tcache = TW.decode_step(tparams, torch.from_numpy(tok), pos, tcache,
                                    tckv, tcfg, torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-4,
                                   atol=2e-4, err_msg=f"pos={pos}")
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)


def test_decode_step_fused_matches_jax(tiny):
    """The fused step over 4 positions: port (kernel wrappers, plain versions
    on CPU) vs JAX (Pallas kernels in interpret mode); tolerance 2e-4 as
    tests/test_decoder_fused.py:254."""
    jcfg, tcfg, jparams, tparams, _, mel = tiny
    enc, jckv, tckv = _cross_kv(jcfg, tcfg, jparams, tparams, mel)
    Bt, s_real = mel.shape[0], enc.shape[1]
    s_pad = 128
    jckv_pad = {k: jnp.pad(v, [(0, 0), (0, 0), (0, s_pad - s_real), (0, 0),
                               (0, 0)]).reshape(v.shape[0], v.shape[1], s_pad, -1)
                for k, v in jckv.items()}
    tckv_pad = {k: torch.tensor(np.asarray(v)) for k, v in jckv_pad.items()}
    jcache = JW.init_cache(jcfg, Bt, 128, dtype=jnp.float32, dense=True)
    tcache = TW.init_cache(tcfg, Bt, 128, dtype=torch.float32, dense=True)
    rng = np.random.default_rng(3)
    for pos in range(4):
        tok = rng.integers(0, jcfg.vocab_size, Bt)
        lj, jcache = JW.decode_step_fused(jparams, jnp.asarray(tok, jnp.int32),
                                          jnp.int32(pos), jcache, jckv_pad, jcfg,
                                          s_real, jnp.float32)
        lt, tcache = TW.decode_step_fused(tparams, torch.from_numpy(tok), pos,
                                          tcache, tckv_pad, tcfg, s_real,
                                          torch.float32)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-4,
                                   atol=2e-4, err_msg=f"pos={pos}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=1e-5, atol=1e-5)


def test_decode_step_fused_needs_64_dim_heads():
    cfg = TConfig(**{**TINY, "decoder_heads": 8})
    with pytest.raises(ValueError, match="64-dim heads"):
        TW.decode_step_fused({"decoder": {}}, torch.zeros(1, dtype=torch.long), 0,
                             {}, {}, cfg, 1, torch.float32)
