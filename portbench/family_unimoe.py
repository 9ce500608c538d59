"""The Uni-MoE family (HIT-TMG/Uni-MoE-2.0-Omni's speech-to-text path, the
port's models/unimoe.py): configuration files with "family": "unimoe".
Binds the family contract of families.py to weights_unimoe.py and
reference_unimoe.py, and holds the useful FLOPs of a training step and
the expert layers' counters the readers take (the port's moe_counters,
read where the program has them).

Training cells only: the port has no serving path for this model, so
served_gaps and the decode FLOP counts raise.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

from . import family_whisper as FW
from . import yardstick as Y
from .reference_unimoe import train_steps  # noqa: F401
from .weights_unimoe import dims, leaves, make_adapters, make_weights  # noqa: F401

PREFIX = (151644,)      # <|im_start|>
EOT = 151645            # <|im_end|>
check_program_settings = FW.check_program_settings
# the configuration file's keys and the port's UniMoEConfig fields they set
PORT_FIELDS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
               "num_key_value_heads", "vocab_size", "rms_norm_eps", "rope_theta",
               "shared_intermediate_size", "mlp_fixed_expert_num", "dynamic_intermediate_size",
               "mlp_dynamic_expert_num", "mlp_dynamic_null_expert_num", "mlp_dynamic_top_p",
               "mlp_dynamic_top_k")
ENCODER_FIELDS = (("d_model", "d_model"), ("encoder_layers", "encoder_layers"),
                  ("encoder_attention_heads", "encoder_heads"), ("num_mel_bins", "num_mel_bins"),
                  ("max_source_positions", "max_source_positions"))


def _port_knows_the_model() -> None:
    """A port without this model (an unknown model type) stops the run as
    the family loads, before any kernel is built or weight made."""
    from asr_finetune_tpu_torch.models.configs import get_config
    get_config("HIT-TMG/Uni-MoE-2.0-Omni")


_port_knows_the_model()


def reference_opts(args, seed) -> Dict[str, Any]:
    """The Whisper family's settings with this model's prefix and end."""
    return dict(FW.reference_opts(args, seed), prefix=PREFIX, eot=EOT)


@contextlib.contextmanager
def injected(weights: Dict[str, Any], adapters):
    """The port's random init replaced, for one build, by the benchmark's
    trees (handed over once, so the port alone holds them)."""
    from asr_finetune_tpu_torch.models import unimoe as PU
    from asr_finetune_tpu_torch.training import lora as PL
    held = {"w": weights, "a": adapters}
    orig_w, orig_a = PU.init_params, PL.init_adapters

    def init_params(cfg, seed=0, device="cpu", int8=False):
        if not int8:
            raise ValueError("the benchmark's Uni-MoE weights are the int8 base")
        return held.pop("w")

    def init_adapters(g, model_cfg, cfg, encoder=False, device="cpu"):
        return held.pop("a")
    PU.init_params, PL.init_adapters = init_params, init_adapters
    try:
        yield
    finally:
        PU.init_params, PL.init_adapters = orig_w, orig_a
        held.clear()


def moe_counts() -> Optional[Dict[str, int]]:
    """The port's expert-layer counters since the process started
    (models/unimoe.moe_counters), or None where the program has none."""
    try:
        from asr_finetune_tpu_torch.models import unimoe
    except ImportError:
        return None
    read = getattr(unimoe, "moe_counters", None)
    return None if read is None else read()


# ------------------------------------------------------------ useful FLOPs

def encoder_flops(n: Dict[str, int], batch: int) -> float:
    """The Whisper encoder's forward matmul FLOPs (yardstick.py)."""
    return Y.encoder_flops({"d": n["d_e"], "ff": n["ff"], "L_e": n["L_e"], "mels": n["mels"]},
                           batch)


def lm_flops(n: Dict[str, int], batch: int, label_len: int,
             expert_rows_per_token: float) -> float:
    """Forward matmul FLOPs of the projector, the LM over A + label_len
    positions and the head over the text positions: each layer's q/k/v/o,
    the causal attention's QK^T and PV over the keys at or before each
    query, the fp32 gate, the fixed experts on every token and the dynamic
    experts on expert_rows_per_token rows a token (three products each)."""
    d, hd, H, Hk = n["d"], n["hd"], n["H"], n["H_kv"]
    T = n["A"] + label_len
    proj = 2.0 * (2 * d * H * hd + 2 * d * Hk * hd)
    attn = 2 * 2.0 * H * hd * T * (T + 1) / 2 / T
    router = 2.0 * d * (n["Ed"] + n["En"])
    experts = 3 * 2.0 * d * (n["Ef"] * n["Fs"] + expert_rows_per_token * n["Fd"])
    per_token = n["L"] * (proj + attn + router + experts)
    return batch * (2.0 * n["A"] * n["d_e"] * d + T * per_token
                    + 2.0 * label_len * d * n["V"])


def train_step_flops(n: Dict[str, int], batch: int, label_len: int, mode: str,
                     expert_rows_per_token: Optional[float] = None) -> float:
    """Useful FLOPs of a training step with adapters: 2x the forward (the
    forward and the input gradients), remat's recompute left out; the
    dynamic experts' part from the rows they computed a token (the
    program's counters)."""
    if mode != "peft" or expert_rows_per_token is None:
        raise ValueError("Uni-MoE's step FLOPs are counted for PEFT, from the routed rows")
    return 2.0 * (encoder_flops(n, batch) + lm_flops(n, batch, label_len,
                                                     expert_rows_per_token))


def _no_serving(*args, **kwargs):
    raise NotImplementedError("the port has no serving path for Uni-MoE-2.0-Omni")


served_gaps = cross_kv_flops = decode_position_flops = _no_serving


# ------------------------------------------------------------ the manifest

def check_config(c: Dict[str, Any]) -> None:
    """The published configuration, nothing cut: heads of 128, query heads
    in whole groups over the KV heads, the encoder Whisper-large's."""
    if c["reduced"] != []:
        raise ValueError(f"Uni-MoE-2.0-Omni is run whole, not cut by {c['reduced']}")
    if c["hidden_size"] // c["num_attention_heads"] != 128:
        raise ValueError("the head width is not 128")
    if c["num_attention_heads"] % c["num_key_value_heads"]:
        raise ValueError("the query heads do not group over the KV heads")
    e = c["whisper_encoder"]
    if e["d_model"] != c["whisper_hidden_size"] or e["encoder_ffn_dim"] != 4 * e["d_model"]:
        raise ValueError("the encoder is not Whisper-large's at whisper_hidden_size")
    if c["intermediate_size"] != c["dynamic_intermediate_size"]:
        raise ValueError("the dynamic experts are not intermediate_size wide")


def port_matches(c: Dict[str, Any]) -> bool:
    """The port's configuration of the file's model_type has the file's
    widths, its encoder's and its pooling."""
    from asr_finetune_tpu_torch.models.configs import get_config
    p = get_config(c["model_type"])
    return (all(getattr(p, k) == c[k] for k in PORT_FIELDS)
            and all(getattr(p.encoder, f) == c["whisper_encoder"][k] for k, f in ENCODER_FIELDS)
            and p.audio_pool == c["assumed"]["audio_pool"])
