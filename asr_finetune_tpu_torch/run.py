"""Model building for the port's serving path (counterpart of asr_finetune_tpu/run.py).

`build_model` loads a native checkpoint (the JAX export) or an HF checkpoint
directory from --model_path, or random-initialises --model_type (smoke-test
mode: byte-fallback tokenizer, special ids aligned with it, as the JAX
build_model does), on --device; with --bf16 the matmul weights are cast to
bf16 once here. The training half of the JAX module
(run_trial, build_data) is not ported yet; --peft and --load_in_8bit raise.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Optional

import torch

from .device import resolve_device
from .models import native_io
from .models import whisper as W
from .models.configs import WhisperConfig, get_config
from .models.convert_hf import load_pretrained
from .models.tokenizer import load_tokenizer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BuiltModel:
    cfg: WhisperConfig
    params: Dict[str, Any]
    tokenizer: Any
    device: torch.device
    suppress_tokens: Optional[list] = None  # whisper generation_config list
    begin_suppress_tokens: Optional[list] = None


def build_model(args) -> BuiltModel:
    if args.peft or args.load_in_8bit:
        raise NotImplementedError(
            "--peft / --load_in_8bit: LoRA adapters and the int8 base belong "
            "to the training slice of the port, not ported yet")
    device = resolve_device(args.device)
    if args.model_path:
        if native_io.is_native_checkpoint(args.model_path):
            params, cfg = native_io.load_params(args.model_path, device)
        else:
            params, cfg = load_pretrained(args.model_path, device)
        tokenizer = load_tokenizer(args.model_path, cfg.vocab_size)
    else:
        cfg = get_config(args.model_type)
        params = W.init_params(cfg, seed=args.random_seed, device=device)
        tokenizer = load_tokenizer(None)
        if cfg.vocab_size > 1000:
            logger.warning("no --model_path: random init + byte-fallback "
                           "tokenizer (smoke-test mode)")
        # align model special ids with the byte-fallback tokenizer layout
        cfg = dataclasses.replace(
            cfg, eos_token_id=tokenizer.special.eot,
            sot_token_id=tokenizer.special.sot,
            pad_token_id=tokenizer.special.pad)
    if args.bf16:
        # serving computes every product in bf16: cast the weights once
        # rather than at every use, and hand the dead fp32 originals back to
        # the driver instead of keeping them reserved in the caching allocator
        W.cast_matmul_weights_(params, torch.bfloat16)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    suppress = begin_suppress = None
    if args.model_path:
        gen_cfg_path = os.path.join(args.model_path, "generation_config.json")
        if os.path.exists(gen_cfg_path):
            with open(gen_cfg_path) as f:
                gen_cfg = json.load(f)
            suppress = gen_cfg.get("suppress_tokens")
            # HF suppresses these only at the first free position (" ", eos)
            begin_suppress = gen_cfg.get("begin_suppress_tokens")
    return BuiltModel(cfg, params, tokenizer, device, suppress, begin_suppress)
