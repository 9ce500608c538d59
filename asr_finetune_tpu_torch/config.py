"""Config / flag system: every flag settable on the CLI or in a `.config`
file passed with -c.

Capability parity with the reference's configargparse setup
(train_hyper.py:60-159, ~50 flags; list-valued flags via the comma-split
`list_of_strings` type, training/utils.py:31-41). configargparse is not a
dependency here; the same `key = value` config-file format is parsed
natively so the reference's .config files carry over with only path edits.

Warts deliberately NOT replicated (SURVEY.md §5.6): no post-parse overrides
of user flags; no per-key dict deletions before splatting.

The PyTorch port keeps its own copy of the flags (the port imports nothing
of asr_finetune_tpu) and adds --device. Flags of paths not ported yet
(SpecAugment, offload, tensor parallelism, HPO, parquet data) parse as
before; the code that reads them raises NotImplementedError where it meets
one that is set.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

DATA_MODES = ("h5", "parquet", "parquet_h5", "train_parquet", "val_parquet",
              "val_h5", "folder")
SEARCH_MODES = ("small_small", "large_small_OPTUNA", "large_small_BOHB",
                "large_large")
LR_SCHEDULERS = ("linear", "cosine", "constant")


def list_of_strings(value: str) -> List[str]:
    """Comma-split list type (reference training/utils.py:31-41)."""
    return [v.strip() for v in value.split(",") if v.strip()]


def _read_config_file(path: str) -> List[str]:
    """`key = value` lines → CLI argv fragments (configargparse format)."""
    argv: List[str] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].split(";", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, value = (x.strip() for x in line.split("=", 1))
            else:
                key, value = line, ""
            key = "--" + key.lstrip("-")
            value = value.strip()
            if value.lower() in ("true", ""):
                argv.append(key)
            elif value.lower() == "false":
                # boolean flags are BooleanOptionalAction, so `key = false`
                # really disables default-True flags (bf16, remat, ...)
                argv.append("--no-" + key.lstrip("-"))
            else:
                if value and value[0] in "\"'" and value[-1:] == value[0]:
                    value = value[1:-1]
                argv.extend([key, value])
    return argv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Whisper fine-tuning and inference (PyTorch/CUDA port)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; cuda without a CUDA device "
                        "raises instead of falling back to the CPU")

    # training cadence (Seq2SeqTrainingArguments-equivalents)
    p.add_argument("--per_device_train_batch_size", type=int, default=16)
    p.add_argument("--per_device_eval_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--output_tag", type=str, default="whisper-tiny-de")
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--num_train_epochs", type=int, default=10)
    p.add_argument("--generation_max_length", type=int, default=225)
    p.add_argument("--generation_num_beams", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=1.0,
                   help="beam-search length penalty (HF GenerationConfig "
                        "semantics: finished score = logprob-sum / "
                        "generated_len**penalty)")
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--eval_delay", type=int, default=0)
    p.add_argument("--logging_steps", type=int, default=25)
    p.add_argument("--dataloader_num_workers", type=int, default=1)
    p.add_argument("--prefetch_batches", type=int, default=2)

    # optimizer / schedule
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_scheduler_type", type=str, default="linear",
                   choices=LR_SCHEDULERS)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--warmup_ratio", type=float, default=0.0)
    p.add_argument("--max_warmup_steps", type=int, default=10)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--label_smoothing", type=float, default=0.0)

    # model
    p.add_argument("--model_type", type=str, default="openai/whisper-tiny")
    p.add_argument("--model_path", type=str, default="",
                   help="Local HF checkpoint dir (weights + vocab); empty = "
                        "random init + byte-fallback tokenizer")
    p.add_argument("--target_language", type=str, default="german")
    p.add_argument("--task", type=str, default="transcribe")
    p.add_argument("--return_timestamps", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--peft", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--load_in_8bit", action=argparse.BooleanOptionalAction, default=False,
                   help="int8-quantize the frozen base (PEFT)")
    p.add_argument("--decode_kv_int8", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="stream int8 cross-attention K/V during WER decode "
                        "(halves the dominant per-token HBM read; enables "
                        "larger eval batches)")
    p.add_argument("--decode_w_int8", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="stream int8 decoder weights during WER decode")
    p.add_argument("--int8_matmul", action=argparse.BooleanOptionalAction, default=False,
                   help="compute frozen-base matmuls in int8 on the MXU "
                        "(vector-wise W8A8, bitsandbytes-style); needs "
                        "--load_in_8bit")
    p.add_argument("--int8_outlier_cols", type=int, default=8,
                   help="with --int8_matmul: route the k largest-|amax| "
                        "input features of every W8A8 matmul through a "
                        "float side-matmul (fixed-k, jit-friendly form of "
                        "bnb LLM.int8()'s fp16 outlier columns); 0 = off. "
                        "Default 8 for bitsandbytes numerics parity: the "
                        "reference's load_in_8bit ALWAYS decomposes "
                        "outliers (threshold 6.0), and k=8 measured 0.20% "
                        "matmul error vs 5.7% plain-W8A8 on outlier-heavy "
                        "activations (bench_quant_numerics.py) while being "
                        "loss-neutral e2e when no outliers are present "
                        "(bench_int8_outlier_ab.py)")
    p.add_argument("--int8_outlier_calibrate",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="with --int8_matmul and outlier cols > 0: record "
                        "column amax over one eval batch at startup and "
                        "install bitsandbytes' threshold-rule outlier "
                        "columns as STATIC per-shape sets (exact bnb "
                        "semantics: only features whose |activation| "
                        "crosses the threshold are decomposed — none on "
                        "outlier-free data). Removes the per-matmul "
                        "dynamic ranking (~8%% of the large-v3 parity "
                        "step). --no-int8_outlier_calibrate keeps the "
                        "per-matmul dynamic top-k")
    p.add_argument("--int8_outlier_threshold", type=float, default=6.0,
                   help="calibration threshold on |activation| for outlier "
                        "columns (bitsandbytes Linear8bitLt default 6.0)")
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_targets", type=str, default="all",
                   choices=("all", "decoder"),
                   help="'all' adapts every q/v projection incl. encoder "
                        "self-attention (reference PEFT parity: "
                        "target_modules=['q_proj','v_proj'] suffix-matches "
                        "the whole model, trainers.py:525); 'decoder' "
                        "adapts decoder self/cross q,v only")
    p.add_argument("--offload_optimizer", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="keep Adam m/v in pinned host memory between steps "
                        "(DeepSpeed ZeRO-3 offload_optimizer analogue, "
                        "reference trainers.py:403-406); for configs whose "
                        "optimizer state exceeds HBM")
    p.add_argument("--offload_param", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="PEFT: keep the frozen base in pinned host memory, "
                        "gathered HBM-ward inside each step (ZeRO-3 "
                        "offload_param analogue, trainers.py:407-410)")
    p.add_argument("--adalora", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--adalora_target_rank", type=int, default=0,
                   help="0 = rank//2")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--fp16", action=argparse.BooleanOptionalAction, default=False,
                   help="accepted for reference-config compat; TPU uses bf16")
    p.add_argument("--gradient_checkpointing", action=argparse.BooleanOptionalAction, default=True)

    # data
    p.add_argument("--data_mode", type=str, default="h5", choices=DATA_MODES)
    p.add_argument("--path_to_data", type=str, default="")
    p.add_argument("--dataset_name", type=str, default="eg_dataset_subset_1000.h5")
    p.add_argument("--val_dataset_name", type=str, default="")
    p.add_argument("--test_split", type=float, default=0.2)
    p.add_argument("--val_split", type=float, default=0.1)
    p.add_argument("--on_device_logmel", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--host_logmel", action=argparse.BooleanOptionalAction, default=False,
                   help="compute features on host (reference behavior)")
    p.add_argument("--copy_to_local", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--spec_augment", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--group_by_length", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="sort-within-window batching by transcript length "
                        "(reference group_by_length=True, trainers.py:862)")

    # evaluation
    p.add_argument("--metric_to_optimize", type=list_of_strings,
                   action="append", default=None)
    p.add_argument("--modes", type=list_of_strings, action="append",
                   default=None)
    p.add_argument("--wer_weight", type=float, default=1.0)
    p.add_argument("--eval_sample_fraction", type=float, default=1.0)
    p.add_argument("--skip_wer_eval", action=argparse.BooleanOptionalAction, default=False,
                   help="loss-only eval (skips the decode path)")
    p.add_argument("--num_to_keep", type=int, default=1)

    # HPO
    p.add_argument("--num_samples", type=int, default=5)
    p.add_argument("--max_concurrent_trials", type=int, default=1)
    p.add_argument("--max_t", type=int, default=10)
    p.add_argument("--search_schedule_mode", type=str,
                   default="large_small_OPTUNA", choices=SEARCH_MODES)
    p.add_argument("--reduction_factor", type=int, default=2)
    p.add_argument("--grace_period", type=int, default=1)
    p.add_argument("--perturbation_interval", type=int, default=10)
    p.add_argument("--burn_in_period", type=int, default=1)
    p.add_argument("--hyperparameters", type=list_of_strings, action="append",
                   default=None)
    p.add_argument("--len_train_set", type=int, default=10)

    # infra
    p.add_argument("--num_workers", type=int, default=1,
                   help="processes (hosts) in the jax.distributed job")
    p.add_argument("--cpus_per_trial", type=int, default=1)
    p.add_argument("--chips_per_trial", type=float, default=0,
                   help="TPU chips per HPO trial (0 = all local chips); "
                        "replaces the reference's fractional gpus_per_trial")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--run_on_local_machine", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--storage_path", type=str, default="./output/scratch")
    p.add_argument("--resume_training", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--debug", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--random_seed", type=int, default=1337)
    p.add_argument("-c", "--config", type=str, default=None,
                   help="config file path (`key = value` lines)")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    import sys

    argv = list(argv if argv is not None else sys.argv[1:])
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-c", "--config", type=str, default=None)
    pre_ns, rest = pre.parse_known_args(argv)

    parser = build_parser()
    if pre_ns.config:
        # config file first so explicit CLI flags win
        ns = parser.parse_args(_read_config_file(pre_ns.config) + rest)
        ns.config = pre_ns.config
    else:
        ns = parser.parse_args(argv)
    if ns.debug:
        ns.limit_samples = 100  # reference: datasets_and_collators.py:534,596
    else:
        ns.limit_samples = None
    return ns
