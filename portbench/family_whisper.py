"""The Whisper family (encoder-decoder, the port's models/whisper.py): every
configuration file without a "family" key. Binds the family contract of
families.py to the functions of weights.py, reference.py and yardstick.py,
and holds what the runners need of the program's Whisper build: the
injection of the benchmark's trees, the forced prefix, and the reference's
settings read from the program's options.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

from .reference import served_gaps, train_steps  # noqa: F401
from .weights import dims, leaves, make_adapters, make_weights  # noqa: F401
from .yardstick import (cross_kv_flops, decode_position_flops,  # noqa: F401
                        encoder_flops, train_step_flops)

EOT = 256
PREFIX = (257, 258, 261, 262)   # sot, <|de|>, transcribe, notimestamps (byte layout)
# the program's adapter settings that are no options: the values the
# reference follows, checked against the program's after its build
LORA_DROPOUT, ORTH_REG_WEIGHT = 0.05, 0.8
# options the reference follows at these values only
ASSUMED = {"lr_scheduler_type": "linear", "warmup_steps": 0, "warmup_ratio": 0.0,
           "label_smoothing": 0.0, "gradient_accumulation_steps": 1, "tp": 1,
           "bf16": True, "fp16": False}
# the configuration file's keys and the port's ModelConfig fields they set
PORT_FIELDS = (("d_model", "d_model"), ("encoder_layers", "encoder_layers"),
               ("decoder_layers", "decoder_layers"), ("encoder_attention_heads", "encoder_heads"),
               ("decoder_attention_heads", "decoder_heads"), ("encoder_ffn_dim", "d_ff"),
               ("num_mel_bins", "num_mel_bins"), ("vocab_size", "vocab_size"),
               ("max_source_positions", "max_source_positions"),
               ("max_target_positions", "max_target_positions"))


def reference_opts(args, seed) -> Dict[str, Any]:
    """The reference's settings, read from the program's parsed options;
    an option the reference does not follow stops the run."""
    off = {k: getattr(args, k) for k, v in ASSUMED.items() if getattr(args, k) != v}
    if off:
        raise ValueError(f"the reference follows none of these options: {off}")
    peft = bool(args.peft)
    int8 = peft and bool(args.load_in_8bit)
    if int8 and not args.int8_matmul:
        raise ValueError("the reference follows the int8 base only through W8A8 (--int8_matmul)")
    return {"mode": "peft" if peft else "full", "lora_rank": args.lora_rank,
            "lora_alpha": args.lora_alpha, "lora_dropout": LORA_DROPOUT,
            "adalora": bool(args.adalora), "orth_reg_weight": ORTH_REG_WEIGHT,
            "encoder_adapters": args.lora_targets == "all", "int8": int8,
            "outlier_cols": args.int8_outlier_cols,
            "outlier_threshold": args.int8_outlier_threshold,
            "calibrate": bool(int8 and args.int8_outlier_cols and args.int8_outlier_calibrate),
            "lr": args.learning_rate, "weight_decay": args.weight_decay,
            "max_steps": args.max_steps, "max_grad_norm": args.max_grad_norm,
            "spec_augment": bool(args.spec_augment),
            "seed": seed, "prefix": PREFIX, "eot": EOT}


def check_program_settings(trainer, opts, check_steps) -> None:
    lora = trainer.step_cfg.lora
    if lora is None:
        return
    if (lora.dropout, lora.orth_reg_weight) != (opts["lora_dropout"], opts["orth_reg_weight"]):
        raise ValueError(f"the program's lora dropout {lora.dropout} and orthogonality "
                         f"weight {lora.orth_reg_weight} are not the reference's")
    if lora.adalora and check_steps > lora.tinit_frac * opts["max_steps"]:
        raise ValueError("the checked steps reach AdaLoRA's rank allocation, which the "
                         "reference does not follow")


@contextlib.contextmanager
def injected(weights: Dict[str, Any], adapters):
    """The port's random init replaced, for one build, by the benchmark's
    trees (handed over once, so the port alone holds them)."""
    from asr_finetune_tpu_torch.models import whisper as PW
    from asr_finetune_tpu_torch.training import lora as PL
    held = {"w": weights, "a": adapters}
    orig_w, orig_a = PW.init_params, PL.init_adapters

    def init_params(cfg, seed=0, device="cpu"):
        return held.pop("w")

    def init_adapters(g, model_cfg, cfg, encoder=False, device="cpu"):
        return held.pop("a")
    PW.init_params, PL.init_adapters = init_params, init_adapters
    try:
        yield
    finally:
        PW.init_params, PL.init_adapters = orig_w, orig_a
        held.clear()


def check_config(c: Dict[str, Any]) -> None:
    """A published Whisper configuration, nothing cut: the MLP four times
    the model width, heads of 64."""
    if c["reduced"] != []:
        raise ValueError(f"a Whisper configuration is run whole, not cut by {c['reduced']}")
    if c["encoder_ffn_dim"] != 4 * c["d_model"]:
        raise ValueError("encoder_ffn_dim is not 4 x d_model")
    if c["d_model"] // c["encoder_attention_heads"] != 64:
        raise ValueError("the head width is not 64")


def port_matches(c: Dict[str, Any]) -> bool:
    """The port's configuration of the file's model_type has the file's widths."""
    from asr_finetune_tpu_torch.models.configs import get_config
    p = get_config(c["model_type"])
    return all(getattr(p, field) == c[key] for key, field in PORT_FIELDS)
