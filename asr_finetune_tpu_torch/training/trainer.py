"""The training loop: step cadence, random-shard eval, fused eval_loss_wer,
checkpointing, resume (PyTorch port).

Counterpart of asr_finetune_tpu/training/trainer.py (`Trainer.train` /
`evaluate`, :171-355), single process:
- every step runs the train step (training/train_step.py); per-step metrics
  stay on the device and are fetched once per logging window (loss mean,
  last grad_norm, utterances/s, tokens/s, the memory line);
- every eval_steps (from eval_delay on) one random validation shard is
  evaluated: loss over its batches and, unless disabled, WER of the greedy
  or beam-search decode (evaluation/decode.make_decode_fn, with the
  generation_num_beams, length_penalty, decode_kv_int8 and decode_w_int8
  options: the fused decoder kernels on a card) → eval_loss_wer = (1 - w) eval_loss + w eval_wer; in PEFT the loss
  runs over the unmerged adapters and the decode gets the rank-masked
  adapters, which it merges into the (int8 or bf16) base;
- a checkpoint every save_steps (a multiple of eval_steps, so it is scored
  on fresh metrics) and at the end; resume restores the latest one and
  restarts the data stream at its step.
The JAX trainer's host-offload, multi-host and HPO early-stop hooks are not
ported: the port trains in one process, and HPO is still to port.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.pipeline import to_device
from ..evaluation import decode as decode_lib
from ..evaluation import wer as wer_lib
from ..evaluation.normalize import normalize
from ..models.configs import WhisperConfig
from ..ops import logmel as logmel_ops
from ..utils.logging_utils import MetricsLogger, memory_stats
from . import lora as lora_lib
from .checkpoint import CheckpointManager
from .optim import AdamW
from .train_step import TrainStepConfig, make_eval_loss_step, make_train_step

logger = logging.getLogger(__name__)

DEVICE_KEYS = ("mel", "audio", "decoder_input_ids", "labels")


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    eval_steps: int = 100
    eval_delay: int = 0
    save_steps: int = 200
    logging_steps: int = 10
    metric_for_best_model: str = "eval_loss_wer"
    greater_is_better: bool = False
    wer_weight: float = 0.7
    generation_max_length: int = 225
    generation_num_beams: int = 1
    length_penalty: float = 1.0
    num_to_keep: int = 2
    language: str = "de"
    task: str = "transcribe"
    eval_num_shards: int = 20
    compute_wer: bool = True
    return_timestamps: bool = False
    suppress_tokens: Optional[List[int]] = None
    begin_suppress_tokens: Optional[List[int]] = None
    decode_kv_int8: bool = False
    decode_w_int8: bool = False
    output_dir: str = "./output"
    seed: int = 42

    def __post_init__(self):
        # checkpoint scoring needs a fresh metric
        if self.compute_wer or "wer" in self.metric_for_best_model:
            if self.save_steps % max(self.eval_steps, 1) != 0:
                raise ValueError(
                    f"save_steps ({self.save_steps}) must be a multiple of "
                    f"eval_steps ({self.eval_steps}) so checkpoints are scored "
                    "on fresh metrics")


class Trainer:
    """Single-process training loop over the eager train step."""

    def __init__(self, model_cfg: WhisperConfig, state: Dict[str, Any],
                 opt: AdamW, step_cfg: TrainStepConfig, cfg: TrainerConfig,
                 tokenizer, device: torch.device,
                 train_iter: Callable[[int], Iterator[Dict[str, Any]]],
                 eval_batches_fn: Optional[Callable[[int], List[Dict[str, Any]]]] = None,
                 checkpoints: Optional[CheckpointManager] = None,
                 metrics_logger: Optional[MetricsLogger] = None):
        """train_iter(start_step) → infinite iterator of device batches;
        eval_batches_fn(shard_id) → list of numpy eval batches of one
        validation shard."""
        self.model_cfg = model_cfg
        self.state = state
        self.cfg = cfg
        self.step_cfg = step_cfg
        self.tokenizer = tokenizer
        self.device = device
        self.train_iter = train_iter
        self.eval_batches_fn = eval_batches_fn
        self.checkpoints = checkpoints
        self.metrics = metrics_logger or MetricsLogger(cfg.output_dir)
        self._train_step = make_train_step(model_cfg, opt, step_cfg)
        self._eval_loss_step = make_eval_loss_step(model_cfg, step_cfg)
        forced = tokenizer.prefix_tokens(cfg.language, cfg.task,
                                         predict_timestamps=cfg.return_timestamps)
        sp = tokenizer.special
        self._decode = decode_lib.make_decode_fn(
            model_cfg, forced, cfg.generation_max_length,
            cfg.generation_num_beams, cfg.length_penalty,
            step_cfg.compute_dtype,
            suppress_tokens=cfg.suppress_tokens,
            begin_suppress_tokens=cfg.begin_suppress_tokens,
            timestamp_begin=(sp.timestamp_begin if cfg.return_timestamps
                             else None),
            no_timestamps_id=sp.no_timestamps,
            kv_int8=cfg.decode_kv_int8, w_int8=cfg.decode_w_int8,
            quant=step_cfg.quant)
        self.last_eval_metrics: Dict[str, float] = {}

    # ------------------------------------------------------------------ eval

    def evaluate(self, step: int) -> Dict[str, float]:
        """Random-shard eval: loss (+ WER + fused eval_loss_wer)."""
        if self.eval_batches_fn is None:
            return {}
        rng = np.random.default_rng(self.cfg.seed + step)
        shard_id = int(rng.integers(self.cfg.eval_num_shards))
        batches = self.eval_batches_fn(shard_id)

        losses, counts = [], []
        refs: List[str] = []
        hyps: List[str] = []
        for batch in batches:
            dev_batch = to_device({k: v for k, v in batch.items()
                                   if k in DEVICE_KEYS}, self.device)
            n_valid = int(batch.get("n_valid", len(batch["text"])))
            m = self._eval_loss_step(self.state, dev_batch)
            losses.append(float(m["loss"]))
            counts.append(int(m["tokens"]))
            if self.cfg.compute_wer:
                mel = dev_batch.get("mel")
                if mel is None:
                    mel = logmel_ops.log_mel_spectrogram(
                        dev_batch["audio"], n_mels=self.step_cfg.n_mels)
                adapters = self.state.get("adapters")
                if adapters is not None:
                    with torch.no_grad():
                        adapters = lora_lib.apply_rank_mask(
                            adapters, self.state.get("rank_mask"))
                tokens, _ = self._decode(self.state["params"], mel, adapters)
                texts = self.tokenizer.batch_decode(tokens[:n_valid].cpu().tolist())
                hyps.extend(normalize(t) for t in texts)
                refs.extend(normalize(str(t)) for t in batch["text"][:n_valid])

        total = max(sum(counts), 1)
        eval_loss = float(np.sum([l * c for l, c in zip(losses, counts)]) / total)
        out = {"eval_loss": eval_loss}
        w = self.cfg.wer_weight
        if self.cfg.compute_wer:
            try:
                eval_wer = wer_lib.wer_percent(refs, hyps)
                out["eval_wer"] = eval_wer
                out["eval_loss_wer"] = (1.0 - w) * eval_loss + w * eval_wer
            except Exception as e:  # noqa: BLE001
                # loss-only fallback, as the reference trainer
                logger.warning("WER computation failed (%s); falling back to loss", e)
                out["eval_loss_wer"] = eval_loss
        else:
            out["eval_loss_wer"] = eval_loss
        out["eval_shard"] = shard_id
        self.last_eval_metrics = out
        return out

    # ----------------------------------------------------------------- train

    def train(self, resume: bool = False) -> Dict[str, Any]:
        start_step = 0
        if resume and self.checkpoints is not None:
            latest = self.checkpoints.latest_step()
            if latest is not None:
                self.state = self.checkpoints.restore(self.state, latest)
                start_step = int(latest)
                logger.info("resumed from checkpoint at step %d", start_step)

        it = self.train_iter(start_step)
        t_log = time.time()
        utts_since = 0
        step = start_step
        # per-step metrics stay on the device within a logging window, so the
        # host does not wait for each step before launching the next
        window: List[Dict[str, torch.Tensor]] = []
        try:
            while step < self.cfg.max_steps:
                batch = next(it)
                dev_batch = {k: v for k, v in batch.items() if k in DEVICE_KEYS}
                m = self._train_step(self.state, dev_batch)
                step += 1
                window.append(m)
                utts_since += int(np.prod(dev_batch["labels"].shape[:-1]))

                if step % self.cfg.logging_steps == 0:
                    win = [{k: v.item() for k, v in w_.items()} for w_ in window]
                    dt = time.time() - t_log
                    rec = {
                        "loss": float(np.mean([w_["loss"] for w_ in win])),
                        "grad_norm": float(win[-1]["grad_norm"]),
                        "utt_per_sec": utts_since / max(dt, 1e-9),
                        "tokens_per_sec": sum(w_["tokens"] for w_ in win) / max(dt, 1e-9),
                        **memory_stats(self.device),
                    }
                    self.metrics.log(step, rec)
                    window.clear()
                    utts_since = 0
                    t_log = time.time()

                if self.cfg.eval_steps and step % self.cfg.eval_steps == 0 \
                        and step >= self.cfg.eval_delay:
                    em = self.evaluate(step)
                    if em:
                        self.metrics.log(step, em)
                        logger.info("step %d eval: %s", step,
                                    {k: round(v, 4) for k, v in em.items()})

                if self.checkpoints is not None and self.cfg.save_steps \
                        and step % self.cfg.save_steps == 0:
                    self.checkpoints.save(step, self.state, self.last_eval_metrics)
        finally:
            if hasattr(it, "close"):
                it.close()   # releases the prefetch thread

        if self.checkpoints is not None:
            self.checkpoints.save(self.cfg.max_steps, self.state,
                                  self.last_eval_metrics)
        return {"final_step": step, **self.last_eval_metrics}
