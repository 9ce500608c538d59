"""Import HF Whisper checkpoints (counterpart of asr_finetune_tpu/models/convert_hf.py).

HF torch/safetensors state_dict → the port's parameter tree, in the same
stacked-layer layout and keys as the JAX package's conversion (linear
weights transposed to (d_in, d_out) and stacked to (L, d_in, d_out); conv
weights (out, in, k) → (k, in, out)). `safetensors` is imported only when a
directory holds .safetensors files.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs import WhisperConfig
from .native_io import Params, params_from_numpy


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _stack(sd, fmt: str, n: int, transpose: bool = False) -> np.ndarray:
    arrs = [_np(sd[fmt.format(i)]) for i in range(n)]
    return np.stack([a.T if transpose else a for a in arrs], 0)


def _attn(sd, prefix_fmt: str, n: int, out: Dict[str, np.ndarray], key: str):
    for ours, theirs, bias in (("q", "q_proj", True), ("k", "k_proj", False),
                               ("v", "v_proj", True), ("o", "out_proj", True)):
        out[f"{key}/{ours}/w"] = _stack(sd, f"{prefix_fmt}.{theirs}.weight", n, True)
        if bias:  # k_proj has no bias in Whisper
            out[f"{key}/{ours}/b"] = _stack(sd, f"{prefix_fmt}.{theirs}.bias", n)


def _ln(sd, fmt: str, n, out: Dict[str, np.ndarray], key: str):
    if n is None:
        out[f"{key}/scale"] = _np(sd[fmt + ".weight"])
        out[f"{key}/bias"] = _np(sd[fmt + ".bias"])
    else:
        out[f"{key}/scale"] = _stack(sd, fmt + ".weight", n)
        out[f"{key}/bias"] = _stack(sd, fmt + ".bias", n)


def _mlp(sd, prefix_fmt: str, n: int, out: Dict[str, np.ndarray], key: str):
    for fc in ("fc1", "fc2"):
        out[f"{key}/{fc}/w"] = _stack(sd, f"{prefix_fmt}.{fc}.weight", n, True)
        out[f"{key}/{fc}/b"] = _stack(sd, f"{prefix_fmt}.{fc}.bias", n)


def _state_dict_to_flat(sd: Mapping[str, Any], cfg: WhisperConfig
                       ) -> Dict[str, np.ndarray]:
    """HF WhisperForConditionalGeneration state_dict → flat {path: array}
    with the native checkpoint's keys."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    out: Dict[str, np.ndarray] = {}
    for conv in ("conv1", "conv2"):
        # torch Conv1d weight is (out, in, k); ours is (k, in, out)
        out[f"encoder/{conv}/w"] = _np(sd[f"encoder.{conv}.weight"]).transpose(2, 1, 0)
        out[f"encoder/{conv}/b"] = _np(sd[f"encoder.{conv}.bias"])
    _ln(sd, "encoder.layers.{}.self_attn_layer_norm", Le, out, "encoder/layers/ln1")
    _attn(sd, "encoder.layers.{}.self_attn", Le, out, "encoder/layers/attn")
    _ln(sd, "encoder.layers.{}.final_layer_norm", Le, out, "encoder/layers/ln2")
    _mlp(sd, "encoder.layers.{}", Le, out, "encoder/layers/mlp")
    _ln(sd, "encoder.layer_norm", None, out, "encoder/ln_post")

    out["decoder/embed"] = _np(sd["decoder.embed_tokens.weight"])
    out["decoder/pos"] = _np(sd["decoder.embed_positions.weight"])
    _ln(sd, "decoder.layers.{}.self_attn_layer_norm", Ld, out, "decoder/layers/ln1")
    _attn(sd, "decoder.layers.{}.self_attn", Ld, out, "decoder/layers/self_attn")
    _ln(sd, "decoder.layers.{}.encoder_attn_layer_norm", Ld, out, "decoder/layers/ln2")
    _attn(sd, "decoder.layers.{}.encoder_attn", Ld, out, "decoder/layers/cross_attn")
    _ln(sd, "decoder.layers.{}.final_layer_norm", Ld, out, "decoder/layers/ln3")
    _mlp(sd, "decoder.layers.{}", Ld, out, "decoder/layers/mlp")
    _ln(sd, "decoder.layer_norm", None, out, "decoder/ln_post")
    out["encoder_pos"] = _np(sd["encoder.embed_positions.weight"])
    return out


def from_hf_state_dict(sd: Mapping[str, Any], cfg: WhisperConfig,
                       device="cpu") -> Params:
    """Convert an HF WhisperForConditionalGeneration state_dict → params."""
    return params_from_numpy(_state_dict_to_flat(sd, cfg), device)


def config_from_hf(hf_config) -> WhisperConfig:
    """WhisperConfig from an HF WhisperConfig object or dict; the special-
    token layout follows the vocab size (51866 large-v3, 51864 .en, 51865
    the multilingual v1/v2 layout)."""
    get = (lambda k, d=None: getattr(hf_config, k, d)) if not isinstance(hf_config, dict) \
        else (lambda k, d=None: hf_config.get(k, d))
    from .tokenizer import SpecialTokens
    sp = SpecialTokens.for_vocab(get("vocab_size"))
    return WhisperConfig(
        vocab_size=get("vocab_size"),
        num_mel_bins=get("num_mel_bins"),
        d_model=get("d_model"),
        encoder_layers=get("encoder_layers"),
        encoder_heads=get("encoder_attention_heads"),
        decoder_layers=get("decoder_layers"),
        decoder_heads=get("decoder_attention_heads"),
        d_ff=get("encoder_ffn_dim"),
        max_source_positions=get("max_source_positions", 1500),
        max_target_positions=get("max_target_positions", 448),
        eos_token_id=get("eos_token_id", sp.eot),
        sot_token_id=get("decoder_start_token_id", sp.sot),
        pad_token_id=get("pad_token_id", sp.eot),
        translate_token_id=sp.translate,
        transcribe_token_id=sp.transcribe,
        no_timestamps_token_id=sp.no_timestamps,
        timestamp_begin_id=sp.timestamp_begin,
        first_language_token_id=sp.first_language,
    )


def load_checkpoint_dir(path: str) -> Dict[str, Any]:
    """Read an HF checkpoint directory (safetensors preferred, torch .bin else)."""
    sd: Dict[str, Any] = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        from safetensors.numpy import load_file
        for f in st_files:
            sd.update(load_file(os.path.join(path, f)))
        return sd
    bins = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if bins:
        for f in bins:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                                 weights_only=True))
        return sd
    raise FileNotFoundError(f"no .safetensors or .bin weights under {path}")


def load_pretrained(path: str, device="cpu"):
    """(params, cfg) from an HF model directory with config.json + weights."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    return from_hf_state_dict(load_checkpoint_dir(path), cfg, device), cfg
