"""Model, data and trial building for the port (counterpart of asr_finetune_tpu/run.py).

`build_model` loads a native checkpoint (the JAX export) or an HF checkpoint
directory from --model_path, or random-initialises --model_type (smoke-test
mode: byte-fallback tokenizer, special ids aligned with it, as the JAX
build_model does), on --device. For serving (`train=False`), --bf16 casts
the matmul weights to bf16 once here; for full fine-tuning the weights stay
fp32 masters and the step casts them at use, as the JAX train step does.
With --peft (JAX run.py:87-106) it also draws the LoRA/AdaLoRA adapters
(--lora_targets all: encoder and decoder q/v) and freezes the base: int8
per output channel with --load_in_8bit (the other leaves stay fp32), else
every leaf cast to bf16.

`build_data` and `run_trial` are the training half, single process:
reader + collator + length-grouped sampler + prefetch, the validation split
into eval shards, AdamW (in PEFT over the trained adapter leaves), the train
step, the int8 outlier calibration, checkpoints (adapters only in PEFT) and
the Trainer; its eval decode takes --generation_num_beams,
--length_penalty, --decode_kv_int8 and --decode_w_int8 as transcription
does. Not ported, and raising NotImplementedError: --spec_augment,
--offload_optimizer / --offload_param, --tp > 1, --host_logmel and parquet
data.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .data.collator import Collator, CollatorConfig
from .data.modes import get_data_mode
from .data.pipeline import DataPipeline, IndexSampler, device_prefetch
from .device import resolve_device
from .models import native_io
from .models import whisper as W
from .models.configs import WhisperConfig, get_config
from .models.convert_hf import load_pretrained
from .models.tokenizer import load_tokenizer
from .ops import quant as quant_lib
from .training import lora as lora_lib
from .training import optim as optim_lib
from .training.checkpoint import CheckpointManager, save_trial_manifest
from .training.train_step import (TrainStepConfig, make_eval_loss_step,
                                  make_train_state)
from .training.trainer import Trainer, TrainerConfig
from .utils.logging_utils import MetricsLogger, dump_config, setup_logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BuiltModel:
    cfg: WhisperConfig
    params: Dict[str, Any]
    tokenizer: Any
    device: torch.device
    suppress_tokens: Optional[list] = None  # whisper generation_config list
    begin_suppress_tokens: Optional[list] = None
    adapters: Optional[Dict[str, Any]] = None
    lora: Optional[lora_lib.LoraConfig] = None


def _cast_tree_(tree: Dict[str, Any], dtype: torch.dtype) -> None:
    """Every leaf cast to dtype, in place, each old tensor released as its
    cast replaces it."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _cast_tree_(v, dtype)
        else:
            tree[k] = v.to(dtype)


def build_model(args, train: bool = False,
                hp: Optional[Dict[str, Any]] = None) -> BuiltModel:
    """The model for serving (train=False: --bf16 casts the matmul weights
    once), for full fine-tuning (fp32 master weights whatever --bf16 says)
    or, with --peft, a frozen base and fresh adapters. hp: the trial's
    overrides of rank and alpha."""
    hp = hp or {}
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
    adapters = lcfg = None
    if args.peft:
        lcfg = lora_lib.LoraConfig(
            rank=int(hp.get("rank", args.lora_rank)),
            alpha=float(hp.get("alpha", args.lora_alpha)),
            adalora=args.adalora, target_rank=args.adalora_target_rank or None)
        g = torch.Generator(device=device)
        g.manual_seed(args.random_seed + 1)
        adapters = lora_lib.init_adapters(g, cfg, lcfg,
                                          encoder=args.lora_targets == "all",
                                          device=device)
        if args.load_in_8bit:
            params = quant_lib.quantize_tree_int8(params)
            if args.int8_matmul:
                # the W8A8 kernel reads each frozen weight K-major: one
                # (L, d_out, d_in) copy beside every w_q8, made here once
                params = quant_lib.add_k_major_copies(params)
        else:
            _cast_tree_(params, torch.bfloat16)
    elif args.bf16 and not train:
        # serving computes every product in bf16: cast the weights once
        # rather than at every use
        W.cast_matmul_weights_(params, torch.bfloat16)
    if device.type == "cuda" and (args.peft or not train):
        # release the dead originals' device memory instead of keeping it
        # reserved in the caching allocator
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
    return BuiltModel(cfg, params, tokenizer, device, suppress, begin_suppress,
                      adapters, lcfg)


def _check_pending_training(args) -> None:
    pending = [flag for flag, on in (
        ("--spec_augment", args.spec_augment),
        ("--offload_optimizer", args.offload_optimizer),
        ("--offload_param", args.offload_param),
        ("--tp > 1", args.tp > 1),
        ("--host_logmel", args.host_logmel)) if on]
    if pending:
        raise NotImplementedError(
            f"{', '.join(pending)}: not ported yet (the port trains on one "
            "card with log-mel on the device)")


def _resolve_path(args, name: str) -> str:
    if os.path.isabs(name) or not args.path_to_data:
        return name
    return os.path.join(args.path_to_data, name)


def build_data(args, tokenizer, model_cfg: WhisperConfig, device: torch.device):
    """Returns (train_iter_factory, eval_batches_fn, n_train, num_shards):
    train_iter_factory(start_step) → device batches from that step on;
    eval_batches_fn(shard_id) → the numpy batches of one validation shard."""
    mode = get_data_mode(args.data_mode)
    if "parquet" in (mode["train"], mode["val"]):
        raise NotImplementedError(
            f"--data_mode {args.data_mode}: parquet data is not ported yet")
    ccfg = CollatorConfig(n_mels=model_cfg.num_mel_bins,
                          language=args.target_language, task=args.task)

    def make_reader(kind: str, name: str):
        path = _resolve_path(args, name)
        if kind == "folder":
            from .data.audiofolder import AudioFolderReader
            return AudioFolderReader(path.split(","))
        from .data.hdf5 import Hdf5AudioReader
        return Hdf5AudioReader(path, copy_to_local=args.copy_to_local)

    train_reader = make_reader(mode["train"], args.dataset_name)
    n_total = len(train_reader)
    if args.limit_samples:
        n_total = min(n_total, args.limit_samples)
    if args.val_dataset_name:
        val_reader = make_reader(mode["val"], args.val_dataset_name)
        train_indices = np.arange(n_total)
        val_indices = np.arange(len(val_reader))
    else:
        # deterministic split of one dataset
        perm = np.random.default_rng(args.random_seed).permutation(n_total)
        n_val = max(int(n_total * args.val_split), 1)
        val_indices, train_indices = perm[:n_val], perm[n_val:]
        val_reader = train_reader
    collator = Collator(tokenizer, ccfg)

    # eval shards: the validation set in ~eval_sample_fraction chunks
    frac = max(min(args.eval_sample_fraction, 1.0), 1e-6)
    num_shards = max(int(round(1.0 / frac)), 1)
    shards = np.array_split(val_indices, num_shards)

    accum = args.gradient_accumulation_steps
    lengths = None
    if args.group_by_length and hasattr(train_reader, "transcript_lengths"):
        lengths = np.asarray(train_reader.transcript_lengths())[train_indices]
    sampler = IndexSampler(len(train_indices),
                           args.per_device_train_batch_size * accum,
                           seed=args.random_seed, lengths=lengths)

    class _RemapReader:
        def read(self, idx):
            return train_reader.read(train_indices[np.asarray(idx, int)])

    pipe = DataPipeline(_RemapReader(), collator, sampler)

    def train_iter_factory(start_step: int):
        return device_prefetch(pipe.iter_from_step(start_step), device,
                               size=args.prefetch_batches, accum_steps=accum)

    def eval_batches_fn(shard_id: int) -> List[Dict[str, Any]]:
        """Every utterance of the shard: a short tail is padded up to the
        batch size with repeated rows, masked out of the loss (labels
        -100) and cut from the WER lists by 'n_valid'."""
        idx = np.asarray(shards[shard_id % len(shards)])
        B = args.per_device_eval_batch_size
        out = []
        for i in range(0, len(idx), B):
            rows = val_reader.read(idx[i: i + B])
            if not rows:
                continue
            n_valid = len(rows)
            if n_valid < B:
                rows = [rows[j % n_valid] for j in range(B)]
            batch = collator(rows)
            batch["labels"][n_valid:] = -100
            batch["n_valid"] = n_valid
            out.append(batch)
        return out

    return train_iter_factory, eval_batches_fn, len(train_indices), num_shards


def calibrate_outliers(args, built: BuiltModel, step_cfg: TrainStepConfig,
                       state: Dict[str, Any], eval_batches_fn) -> Dict:
    """bitsandbytes-faithful outlier calibration (JAX run.py:375-426): record
    the column amax of every W8A8 product over the first 4 rows of eval
    batch 0, in a forward without remat and with the dynamic top-k form, and
    install the columns >= --int8_outlier_threshold, at most 2·k per (d_in,
    d_out) class, as step_cfg.quant's static sets. The forward runs the
    train step's kernels: the JAX package calibrates with plain attention
    only because its Pallas TPU kernels cannot run on the CPU devices it
    calibrates on.

    The calibration forward never takes the fused-qkv encoder path
    (fused_qkv=False), whatever ASR_TPU_FUSED_QKV says: the JAX trial's
    attn_impl "xla" makes its gate yield, so JAX calibrates the three
    (d, d) q/k/v products and never the wide (d, 3d) one. The sets then
    hold the JAX classes and nothing more, and under ASR_TPU_FUSED_QKV the
    wide product finds no calibrated class and takes W8A8's dynamic top-k
    form, as in the JAX trial."""
    from .data.pipeline import to_device
    batch = eval_batches_fn(0)[0]
    rows = {k: np.asarray(batch[k])[:4] for k in ("audio", "decoder_input_ids", "labels")
            if k in batch}
    estep = make_eval_loss_step(built.cfg, dataclasses.replace(
        step_cfg, remat=False, fused_qkv=False))
    cstate = {"params": state["params"], "adapters": state.get("adapters")}
    idx_map = quant_lib.calibrate_int8_outliers(
        lambda: estep(cstate, to_device(rows, built.device)), step_cfg.quant,
        threshold=args.int8_outlier_threshold, max_cols=args.int8_outlier_cols * 2)
    logger.info("int8 outlier calibration (thr %.1f): %s", args.int8_outlier_threshold,
                {k: len(v) for k, v in idx_map.items()})
    return idx_map


def setup_trial(args, hp: Optional[Dict[str, Any]] = None) -> Trainer:
    """Everything of one training run up to the first step: model (fp32
    masters, or a frozen base and adapters), AdamW, train state, data, the
    int8 outlier calibration, checkpoints and the Trainer."""
    hp = dict(hp or {})
    setup_logging(logging.DEBUG if args.debug else logging.INFO)
    _check_pending_training(args)
    out_dir = os.path.join(args.output_dir, args.output_tag)
    os.makedirs(out_dir, exist_ok=True)
    dump_config(out_dir, {**vars(args), **{f"hp.{k}": v for k, v in hp.items()}})

    built = build_model(args, train=True, hp=hp)
    cfg = built.cfg
    peft = built.adapters is not None
    warmup_steps = hp.get("warmup_steps", args.warmup_steps or None)
    warmup_ratio = hp.get("warmup_ratio", args.warmup_ratio or None)
    # PEFT: train only a/b (+ e under AdaLoRA); scaling is a constant
    freeze = (optim_lib.adapter_freeze_mask(built.adapters, args.adalora)
              if peft else None)
    opt = optim_lib.make_optimizer(
        float(hp.get("learning_rate", args.learning_rate)), args.max_steps,
        str(hp.get("lr_scheduler_type", args.lr_scheduler_type)),
        warmup_steps=int(warmup_steps) if warmup_steps else None,
        warmup_ratio=float(warmup_ratio) if warmup_ratio else None,
        weight_decay=float(hp.get("weight_decay", args.weight_decay)),
        max_grad_norm=args.max_grad_norm, trainable_mask=freeze)
    int8_base = peft and args.load_in_8bit
    step_cfg = TrainStepConfig(
        mode="peft" if peft else "full",
        accum_steps=args.gradient_accumulation_steps,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        remat=args.gradient_checkpointing,
        label_smoothing=args.label_smoothing,
        on_device_logmel=True, n_mels=cfg.num_mel_bins,
        max_steps=args.max_steps, lora=built.lora, seed=args.random_seed,
        quant=(quant_lib.QuantConfig(matmul=args.int8_matmul,
                                     outlier_cols=args.int8_outlier_cols)
               if int8_base else None))
    state = make_train_state(built.params, opt, built.adapters,
                             adalora=peft and args.adalora)

    train_iter_factory, eval_batches_fn, n_train, num_shards = build_data(
        args, built.tokenizer, cfg, built.device)
    if (int8_base and args.int8_matmul and args.int8_outlier_cols
            and args.int8_outlier_calibrate):
        calibrate_outliers(args, built, step_cfg, state, eval_batches_fn)
    max_steps = args.max_steps or (
        (n_train // max(args.per_device_train_batch_size, 1))
        * args.num_train_epochs)
    tcfg = TrainerConfig(
        max_steps=max_steps, eval_steps=args.eval_steps,
        eval_delay=args.eval_delay, save_steps=args.save_steps,
        logging_steps=args.logging_steps, wer_weight=args.wer_weight,
        generation_max_length=args.generation_max_length,
        generation_num_beams=args.generation_num_beams,
        length_penalty=args.length_penalty, num_to_keep=args.num_to_keep,
        language=args.target_language, task=args.task,
        eval_num_shards=num_shards, compute_wer=not args.skip_wer_eval,
        return_timestamps=args.return_timestamps,
        decode_kv_int8=args.decode_kv_int8, decode_w_int8=args.decode_w_int8,
        suppress_tokens=built.suppress_tokens,
        begin_suppress_tokens=built.begin_suppress_tokens,
        output_dir=out_dir, seed=args.random_seed)
    ckpt = CheckpointManager(
        os.path.join(out_dir, "checkpoints"), max_to_keep=args.num_to_keep,
        metric=tcfg.metric_for_best_model,
        mode="max" if tcfg.greater_is_better else "min", adapter_only=peft)
    return Trainer(cfg, state, opt, step_cfg, tcfg, built.tokenizer,
                   built.device, train_iter=train_iter_factory,
                   eval_batches_fn=eval_batches_fn, checkpoints=ckpt,
                   metrics_logger=MetricsLogger(out_dir))


def run_trial(args, hp: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One full training run with optional hyperparameter overrides."""
    trainer = setup_trial(args, hp)
    try:
        result = trainer.train(resume=args.resume_training)
    finally:
        trainer.metrics.close()
    save_trial_manifest(trainer.cfg.output_dir, {
        "result": result, "hp": hp or {},
        "args": {k: v for k, v in vars(args).items() if not k.startswith("_")}})
    return result
