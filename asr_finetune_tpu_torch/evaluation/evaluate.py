"""Offline model evaluation: resumable, per-utterance transcript dumps
(counterpart of asr_finetune_tpu/evaluation/evaluate.py).

`OfflineEvaluator` streams eval batches, decodes each (greedy or beam
search, evaluation/decode.make_decode_fn: the fused kernels on a card),
accumulates per-utterance and corpus WER over normalized text, and writes
its progress as the JAX evaluator does: `eval_checkpoint.json` (the batch
count done and the results so far) and a versioned `eval_step_N.json`
every `checkpoint_every` batches, `eval_final.json` at the end. A run that
finds a progress file skips the batches it records and appends to its
results.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..models.configs import WhisperConfig
from ..models.tokenizer import WhisperTokenizerBase
from ..ops import logmel
from . import decode as decode_lib
from . import wer as wer_lib
from .normalize import normalize

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalConfig:
    language: str = "de"
    task: str = "transcribe"
    max_length: int = 225
    num_beams: int = 1
    length_penalty: float = 1.0
    return_timestamps: bool = False
    suppress_tokens: Optional[list] = None
    begin_suppress_tokens: Optional[list] = None
    batch_size: int = 8
    checkpoint_every: int = 100   # batches between progress snapshots
    decode_kv_int8: bool = False  # int8 cross-KV during decode
    decode_w_int8: bool = False   # int8 decoder weights during decode
    output_dir: str = "./eval_out"
    compute_dtype: torch.dtype = torch.bfloat16


class OfflineEvaluator:
    """Streams eval batches, decodes, accumulates WER, checkpoints progress.
    Decodes on the device of the parameters."""

    def __init__(self, model_cfg: WhisperConfig, params: Dict[str, Any],
                 tokenizer: WhisperTokenizerBase, cfg: EvalConfig,
                 adapters: Optional[Dict[str, Any]] = None):
        self.model_cfg = model_cfg
        self.params = params
        self.adapters = adapters
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.device = params["decoder"]["embed"].device
        forced = tokenizer.prefix_tokens(cfg.language, cfg.task,
                                         predict_timestamps=cfg.return_timestamps)
        sp = tokenizer.special
        self._decode = decode_lib.make_decode_fn(
            model_cfg, forced, cfg.max_length, cfg.num_beams,
            cfg.length_penalty, cfg.compute_dtype,
            suppress_tokens=cfg.suppress_tokens,
            begin_suppress_tokens=cfg.begin_suppress_tokens,
            timestamp_begin=(sp.timestamp_begin if cfg.return_timestamps
                             else None),
            no_timestamps_id=sp.no_timestamps,
            kv_int8=cfg.decode_kv_int8, w_int8=cfg.decode_w_int8)
        os.makedirs(cfg.output_dir, exist_ok=True)
        self._ckpt_path = os.path.join(cfg.output_dir, "eval_checkpoint.json")

    # -- resumable progress ---------------------------------------------------
    def _load_progress(self) -> Dict[str, Any]:
        if os.path.exists(self._ckpt_path):
            with open(self._ckpt_path) as f:
                p = json.load(f)
            logger.info("resuming eval at batch %d", p["current_count"])
            return p
        return {"current_count": 0, "results": []}

    def _save_progress(self, progress: Dict[str, Any], final: bool = False):
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(progress, f)
        os.replace(tmp, self._ckpt_path)
        if not final:
            step_path = os.path.join(
                self.cfg.output_dir,
                f"eval_step_{progress['current_count']}.json")
            with open(step_path, "w") as f:
                json.dump(progress, f)

    def _mel(self, batch: Dict[str, Any]) -> torch.Tensor:
        mel = batch.get("mel")
        if mel is not None:
            return torch.as_tensor(np.asarray(mel)).to(self.device)
        audio = torch.as_tensor(np.asarray(batch["audio"], np.float32)).to(self.device)
        return logmel.log_mel_spectrogram(audio, n_mels=self.model_cfg.num_mel_bins)

    def run(self, batches: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
        """batches: dicts with "mel" (or "audio") and "text".

        Returns {"wer", "n_utterances", "results": [{original, predicted,
        wer} ...]} and writes eval_final.json.
        """
        progress = self._load_progress()
        start_count = progress["current_count"]
        t0 = time.time()

        for i, batch in enumerate(batches):
            if i < start_count:
                continue  # skip-ahead on resume
            tokens, _ = self._decode(self.params, self._mel(batch), self.adapters)
            preds = self.tokenizer.batch_decode(tokens.cpu().tolist())
            for orig, pred in zip([str(t) for t in batch["text"]], preds):
                n_orig, n_pred = normalize(orig), normalize(pred)
                try:
                    u_wer = wer_lib.wer_percent([n_orig], [n_pred])
                except ValueError:
                    u_wer = None  # empty reference
                progress["results"].append(
                    {"original": orig, "predicted": pred, "wer": u_wer})
            progress["current_count"] = i + 1
            if (i + 1) % self.cfg.checkpoint_every == 0:
                self._save_progress(progress)
                done = progress["current_count"] - start_count
                logger.info("eval batch %d (%.2f batches/s)", i + 1,
                            done / max(time.time() - t0, 1e-9))

        refs = [normalize(r["original"]) for r in progress["results"]]
        hyps = [normalize(r["predicted"]) for r in progress["results"]]
        corpus = wer_lib.wer_percent(refs, hyps) if any(r.split() for r in refs) \
            else float("nan")
        final = {"wer": corpus, "n_utterances": len(refs),
                 "results": progress["results"]}
        with open(os.path.join(self.cfg.output_dir, "eval_final.json"), "w") as f:
            json.dump(final, f, indent=2, ensure_ascii=False)
        self._save_progress(progress, final=True)
        logger.info("eval done: corpus WER %.2f%% over %d utterances",
                    corpus, len(refs))
        return final
