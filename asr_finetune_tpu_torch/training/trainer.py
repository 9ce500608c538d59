"""The training loop: step cadence, random-shard eval, fused eval_loss_wer,
checkpointing, resume (PyTorch port).

Counterpart of asr_finetune_tpu/training/trainer.py (`Trainer.train` /
`evaluate`, :171-355):
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
  restarts the data stream at its step;
- the HPO hook `on_evaluate(step, metrics) -> bool` (the ASHA early-stop
  channel, JAX :115-118, :332-348): called after each eval that yields
  metrics; False stops the trial once that step's periodic checkpoint is
  saved, and the final save still follows, labelled max_steps as in JAX.

Data parallelism (parallel/; JAX :111-144, :185-215, :296-325): each data
rank trains on its rows of the global batch (training/train_step.py).
Every rank builds the same full eval batches and takes its data rank's
contiguous slice; the loss sums and token counts are summed over the data
group, each data rank decodes its slice and the texts are gathered in row
order (from each model group's rank 0: under --tp the ranks of a model
group decode the same rows together, the plain step over their heads), so
every rank computes the same eval metrics. The early-stop verdict is rank
0's, broadcast, or the ranks would part at the next collective. Rank 0
writes metrics.jsonl and every rank its metrics_host<r>.jsonl; each
logging window rank 0's record carries every rank's host<r>_rss_gb,
host<r>_hbm_in_use_gb and host<r>_hbm_peak_gb (one all-gather). An
offloaded frozen base (parallel/sharding.Placement) is copied to the card
once per evaluate().

The logging window's fetch and record run in the span `train.log`
(utils/profiling.py).
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
from ..models import unimoe
from ..models.configs import WhisperConfig
from ..models.whisper import IGNORE_ID
from ..ops import logmel as logmel_ops
from ..parallel import mesh
from ..parallel.sharding import Placement
from ..utils import profiling
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
    """Training loop over the eager train step, in one process or on each
    rank of a group."""

    def __init__(self, model_cfg: WhisperConfig, state: Dict[str, Any],
                 opt: AdamW, step_cfg: TrainStepConfig, cfg: TrainerConfig,
                 tokenizer, device: torch.device,
                 train_iter: Callable[[int], Iterator[Dict[str, Any]]],
                 eval_batches_fn: Optional[Callable[[int], List[Dict[str, Any]]]] = None,
                 checkpoints: Optional[CheckpointManager] = None,
                 metrics_logger: Optional[MetricsLogger] = None,
                 on_evaluate: Optional[Callable[[int, Dict[str, float]], bool]] = None,
                 placement: Optional[Placement] = None):
        """train_iter(start_step) → infinite iterator of device batches;
        eval_batches_fn(shard_id) → list of numpy eval batches of one
        validation shard; on_evaluate(step, metrics) → False to stop the
        trial early; placement: where the frozen base lives between steps."""
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
        self.on_evaluate = on_evaluate
        self.placement = placement or Placement(device)
        self._train_step = make_train_step(model_cfg, opt, step_cfg, self.placement)
        self._eval_loss_step = make_eval_loss_step(model_cfg, step_cfg, rows_of_batch=True)
        self.last_eval_metrics: Dict[str, float] = {}
        if unimoe.is_unimoe(model_cfg):
            # no serving path yet: an evaluation computes its loss, and WER raises
            self._decode = unimoe.no_decode
            return
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

    # ------------------------------------------------------------------ eval

    def evaluate(self, step: int) -> Dict[str, float]:
        """Random-shard eval: loss (+ WER + fused eval_loss_wer)."""
        if self.eval_batches_fn is None:
            return {}
        rng = np.random.default_rng(self.cfg.seed + step)
        shard_id = int(rng.integers(self.cfg.eval_num_shards))
        batches = self.eval_batches_fn(shard_id)
        rank, world = mesh.data_rank(), mesh.data_world()
        # an offloaded base: one copy to the card for the whole evaluation
        state = dict(self.state, params=self.placement.base_on_device(self.state["params"]))
        adapters = state.get("adapters")
        if adapters is not None:
            with torch.no_grad():
                adapters = lora_lib.apply_rank_mask(adapters, state.get("rank_mask"))

        losses, counts = [], []
        refs: List[str] = []
        hyps: List[str] = []
        for batch in batches:
            full = {k: v for k, v in batch.items() if k in DEVICE_KEYS}
            rows = len(next(iter(full.values())))
            if rows % world:
                raise ValueError(f"eval batch {rows} not divisible by {world} ranks")
            lo, nl = rank * rows // world, rows // world
            dev_batch = to_device({k: np.asarray(v)[lo: lo + nl] for k, v in full.items()},
                                  self.device)
            n_valid = int(batch.get("n_valid", len(batch["text"])))
            m = self._eval_loss_step(state, dev_batch)
            if world > 1:
                # the global batch's mean: the ranks' loss sums over their tokens
                n = (dev_batch["labels"] != IGNORE_ID).sum().float()
                total = mesh.all_reduce_sum_(torch.stack([m["loss"] * n, n]), over="data")
                losses.append(float(total[0] / total[1].clamp(min=1)))
                counts.append(max(int(total[1]), 1))
            else:
                losses.append(float(m["loss"]))
                counts.append(int(m["tokens"]))
            if self.cfg.compute_wer:
                mel = dev_batch.get("mel")
                if mel is None:
                    mel = logmel_ops.log_mel_spectrogram(
                        dev_batch["audio"], n_mels=self.step_cfg.n_mels)
                tokens, _ = self._decode(state["params"], mel, adapters)
                texts = self.tokenizer.batch_decode(tokens.cpu().tolist())
                # every data rank's texts, as its model group's rank 0 decoded them
                parts = mesh.all_gather_object(texts)[::mesh.model_world()]
                texts = [t for part in parts for t in part]
                hyps.extend(normalize(t) for t in texts[:n_valid])
                refs.extend(normalize(str(t)) for t in batch["text"][:n_valid])
        decode_lib.release_graphs()   # the decode's buffers go back to training

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
            latest = mesh.broadcast_object(self.checkpoints.latest_step())
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
                # the global batch's utterances: every data rank's rows
                utts_since += int(np.prod(dev_batch["labels"].shape[:-1])) * mesh.data_world()

                if step % self.cfg.logging_steps == 0:
                    with profiling.span("train.log"):
                        win = [{k: v.item() for k, v in w_.items()} for w_ in window]
                        dt = time.time() - t_log
                        host = memory_stats(self.device)
                        self.metrics.log_host(step, host)
                        rec = {
                            "loss": float(np.mean([w_["loss"] for w_ in win])),
                            "grad_norm": float(win[-1]["grad_norm"]),
                            "utt_per_sec": utts_since / max(dt, 1e-9),
                            "tokens_per_sec": sum(w_["tokens"] for w_ in win) / max(dt, 1e-9),
                            **host,
                        }
                        if mesh.world() > 1:
                            every = mesh.all_gather_object([host.get(k, 0.0) for k in (
                                "host_rss_gb", "cuda_mem_in_use_gb", "cuda_peak_gb")])
                            for r, (rss, in_use, peak) in enumerate(every):
                                rec.update({f"host{r}_rss_gb": rss,
                                            f"host{r}_hbm_in_use_gb": in_use,
                                            f"host{r}_hbm_peak_gb": peak})
                        self.metrics.log(step, rec)
                        window.clear()
                        utts_since = 0
                        t_log = time.time()

                stop_early = False
                if self.cfg.eval_steps and step % self.cfg.eval_steps == 0 \
                        and step >= self.cfg.eval_delay:
                    em = self.evaluate(step)
                    if em:
                        self.metrics.log(step, em)
                        logger.info("step %d eval: %s", step,
                                    {k: round(v, 4) for k, v in em.items()})
                        if self.on_evaluate is not None:
                            stop_early = mesh.broadcast_object(
                                not self.on_evaluate(step, em))

                if self.checkpoints is not None and self.cfg.save_steps \
                        and step % self.cfg.save_steps == 0:
                    self.checkpoints.save(step, self.state, self.last_eval_metrics)

                if stop_early:
                    logger.info("trial stopped early at step %d (scheduler)", step)
                    break
        finally:
            if hasattr(it, "close"):
                it.close()   # releases the prefetch thread

        if self.checkpoints is not None:
            self.checkpoints.save(self.cfg.max_steps, self.state,
                                  self.last_eval_metrics)
        return {"final_step": step, **self.last_eval_metrics}
