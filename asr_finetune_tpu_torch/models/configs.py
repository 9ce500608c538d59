"""Whisper model size configurations (tiny → large-v3), and Uni-MoE-2.0-Omni.

Capability parity with the reference's model registry
(reference: finetune/training/models/whisper_models.py:79-113, which loads
HF `openai/whisper-{tiny,base,small,medium,large-v3}` checkpoints). Here the
architecture hyperparameters are first-class so models can be built and
trained without network access; HF checkpoints import via models/convert_hf.py.

The PyTorch port keeps its own copy of this jax-free module (the port imports
nothing of asr_finetune_tpu); keep the two in step.
"""
from __future__ import annotations

import dataclasses

@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Architecture + special-token layout for one Whisper variant."""

    # architecture
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    d_ff: int = 1536  # always 4 * d_model in released Whisper variants
    max_source_positions: int = 1500  # encoder frames after conv stride-2
    max_target_positions: int = 448

    # special tokens (multilingual layout; see models/tokenizer.py)
    eos_token_id: int = 50257
    sot_token_id: int = 50258  # <|startoftranscript|>
    translate_token_id: int = 50358
    transcribe_token_id: int = 50359
    no_timestamps_token_id: int = 50363
    timestamp_begin_id: int = 50364
    pad_token_id: int = 50257
    first_language_token_id: int = 50259  # <|en|>; languages are contiguous

    # training-time defaults
    activation: str = "gelu"
    dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    def language_token_id(self, language_index: int) -> int:
        return self.first_language_token_id + language_index


def _mk(d_model, layers, heads, *, vocab=51865, mels=80, **kw) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=vocab,
        num_mel_bins=mels,
        d_model=d_model,
        encoder_layers=layers,
        encoder_heads=heads,
        decoder_layers=layers,
        decoder_heads=heads,
        d_ff=4 * d_model,
        **kw,
    )


# Official OpenAI Whisper dimensions. large-v3 uses 128 mel bins and adds a
# <|yue|> language token (vocab 51866, timestamp_begin shifts by one).
_V3_SPECIALS = dict(translate_token_id=50359, transcribe_token_id=50360,
                    no_timestamps_token_id=50364, timestamp_begin_id=50365)
# English-only (.en) checkpoints: GPT-2 vocab + specials, no language/task
# tokens (HF forces only <|notimestamps|>; see tokenizer.SpecialTokens)
_EN_SPECIALS = dict(eos_token_id=50256, sot_token_id=50257,
                    pad_token_id=50256, first_language_token_id=50257,
                    translate_token_id=50357, transcribe_token_id=50358,
                    no_timestamps_token_id=50362, timestamp_begin_id=50363)


def _mk_en(d_model, layers, heads):
    return dataclasses.replace(
        _mk(d_model, layers, heads, vocab=51864), **_EN_SPECIALS)


WHISPER_CONFIGS = {
    "tiny": _mk(384, 4, 6),
    "base": _mk(512, 6, 8),
    "small": _mk(768, 12, 12),
    "medium": _mk(1024, 24, 16),
    "large": _mk(1280, 32, 20),  # v1; same dims as v2
    "large-v1": _mk(1280, 32, 20),
    "large-v2": _mk(1280, 32, 20),
    "large-v3": dataclasses.replace(
        _mk(1280, 32, 20, vocab=51866, mels=128), **_V3_SPECIALS),
    # large-v3 encoder with a 4-layer decoder (openai/whisper-large-v3-turbo)
    "large-v3-turbo": dataclasses.replace(
        _mk(1280, 32, 20, vocab=51866, mels=128), decoder_layers=4,
        **_V3_SPECIALS),
    "tiny.en": _mk_en(384, 4, 6),
    "base.en": _mk_en(512, 6, 8),
    "small.en": _mk_en(768, 12, 12),
    "medium.en": _mk_en(1024, 24, 16),
    # distil-whisper (HF distil-whisper/distil-*): full encoder, 2-layer
    # decoder; checkpoints also import via --model_path with dims from
    # their config.json
    "distil-large-v2": dataclasses.replace(
        _mk(1280, 32, 20), decoder_layers=2),
    "distil-large-v3": dataclasses.replace(
        _mk(1280, 32, 20, vocab=51866, mels=128), decoder_layers=2,
        **_V3_SPECIALS),
    "distil-medium.en": dataclasses.replace(
        _mk_en(1024, 24, 16), decoder_layers=2),
    # miniature config for unit tests (not a released variant); special ids
    # follow the byte-fallback tokenizer layout (models/tokenizer.py)
    "test-nano": dataclasses.replace(
        _mk(64, 2, 2, vocab=256 + 16, mels=80),
        eos_token_id=256, sot_token_id=257, first_language_token_id=258,
        translate_token_id=260, transcribe_token_id=261,
        no_timestamps_token_id=262, timestamp_begin_id=263, pad_token_id=256),
}


@dataclasses.dataclass(frozen=True)
class UniMoEConfig:
    """Uni-MoE-2.0-Omni's speech-to-text path (models/unimoe.py): a Whisper
    encoder, mean-pooled to `audio_pool` frames a token and projected
    linearly into a decoder-only GQA language model whose every layer has
    fixed, dynamic and null experts. Field names are the published
    config.json's (HIT-TMG/Uni-MoE-2.0-Omni)."""

    encoder: WhisperConfig
    hidden_size: int = 3584
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    vocab_size: int = 152064
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    shared_intermediate_size: int = 2368
    mlp_fixed_expert_num: int = 2
    dynamic_intermediate_size: int = 18944
    mlp_dynamic_expert_num: int = 4
    mlp_dynamic_null_expert_num: int = 1
    mlp_dynamic_top_p: float = 0.7
    mlp_dynamic_top_k: int = 2
    audio_pool: int = 5            # encoder frames a token: 1500 → 300, 10 a second
    sot_token_id: int = 151644     # <|im_start|>
    eos_token_id: int = 151645     # <|im_end|>

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_mel_bins(self) -> int:
        return self.encoder.num_mel_bins

    @property
    def whisper_hidden_size(self) -> int:
        return self.encoder.d_model


UNIMOE_CONFIGS = {
    "Uni-MoE-2.0-Omni": UniMoEConfig(encoder=WHISPER_CONFIGS["large-v3"]),
    # miniature config for unit tests (not a released model): test-nano's
    # encoder, a 2-layer LM of d 64 with 4 query and 2 KV heads of 16, a
    # byte vocabulary and its two special ids
    "test-unimoe": UniMoEConfig(
        encoder=WHISPER_CONFIGS["test-nano"], hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=288,
        shared_intermediate_size=32, dynamic_intermediate_size=48,
        sot_token_id=272, eos_token_id=273),
}

# the published config.json's own model_type names the model too
UNIMOE_ALIASES = {"grin_qwen2_vl": "Uni-MoE-2.0-Omni"}


def get_config(model_type: str):
    """Resolve a model type like "openai/whisper-tiny",
    "distil-whisper/distil-large-v3", or a bare key like "tiny" to its
    WhisperConfig; "HIT-TMG/Uni-MoE-2.0-Omni" (or its config.json's
    model_type "grin_qwen2_vl", or "test-unimoe") to its UniMoEConfig."""
    key = model_type.rsplit("/", 1)[-1]          # drop the HF org prefix
    key = UNIMOE_ALIASES.get(key, key)
    if key in UNIMOE_CONFIGS:
        return UNIMOE_CONFIGS[key]
    if "whisper-" in key:
        key = key.split("whisper-")[-1]          # openai/whisper-<key>
    if key not in WHISPER_CONFIGS:
        raise ValueError(f"unknown whisper variant {model_type!r}; have {sorted(WHISPER_CONFIGS)}")
    return WHISPER_CONFIGS[key]
