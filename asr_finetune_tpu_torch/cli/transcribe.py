"""Batch transcription entry point: audio files / HDF5 → transcripts (PyTorch port).

`python -m asr_finetune_tpu_torch.cli.transcribe --model_type large-v3
    [--model_path <ckpt dir>] --inputs a.wav dir_of_wavs/ data.h5
    [--output out.jsonl] [--device cuda|cpu]`

Counterpart of asr_finetune_tpu/cli/transcribe.py: wav → log-mel on the
device → encoder → greedy decode, or beam search with
--generation_num_beams K [--length_penalty p] (the fused kernels on a CUDA
device; --decode_kv_int8 / --decode_w_int8 stream int8 cross K/V / decoder
weights) → text. Audio longer than 30 s is decoded window by window and the
window texts joined. Runs on the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys

import numpy as np
import torch

from .. import config as config_lib
from .. import run as run_lib
from ..data.audiofolder import read_wav
from ..data.hdf5 import Hdf5AudioReader
from ..evaluation import decode as decode_lib
from ..ops import logmel


def _gather_inputs(paths):
    items = []  # (kind, path)
    for p in paths:
        if os.path.isdir(p):
            for w in sorted(glob.glob(os.path.join(p, "*.wav"))):
                items.append(("wav", w))
        elif p.endswith(".h5") or p.endswith(".hdf5"):
            items.append(("h5", p))
        else:
            items.append(("wav", p))
    return items


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--inputs", nargs="+", required=True)
    extra.add_argument("--output", default="")
    ens, rest = extra.parse_known_args(argv)
    args = config_lib.parse_args(rest)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    built = run_lib.build_model(args)
    forced = built.tokenizer.prefix_tokens(
        args.target_language, args.task,
        predict_timestamps=args.return_timestamps)
    decode = decode_lib.make_decode_fn(
        built.cfg, forced, args.generation_max_length,
        args.generation_num_beams, args.length_penalty,
        torch.bfloat16 if args.bf16 else torch.float32,
        suppress_tokens=built.suppress_tokens,
        begin_suppress_tokens=built.begin_suppress_tokens,
        kv_int8=args.decode_kv_int8, w_int8=args.decode_w_int8)

    B = args.per_device_eval_batch_size
    # per input file: ordered list of window texts (filled as batches flush)
    chunk_texts: dict = {}
    order: list = []

    def enqueue(pending, name, audio):
        """Split audio into sequential 30 s windows (Whisper's native input
        is one 30 s chunk)."""
        if name not in chunk_texts:
            chunk_texts[name] = []
            order.append(name)
        C = logmel.CHUNK_SAMPLES
        audio = np.asarray(audio, np.float32)
        chunks = ([audio] if audio.size <= C
                  else [audio[i:i + C] for i in range(0, audio.size, C)])
        for ci, chunk in enumerate(chunks):
            chunk_texts[name].append(None)
            pending.append((name, ci, chunk))

    def flush(batch):
        if not batch:
            return
        audios = [logmel.pad_or_trim(a) for _, _, a in batch]
        # pad the batch to size B so every batch has one shape
        while len(audios) < B:
            audios.append(np.zeros(logmel.CHUNK_SAMPLES, np.float32))
        audio = torch.from_numpy(np.stack(audios)).to(built.device)
        mel = logmel.log_mel_spectrogram(audio, n_mels=built.cfg.num_mel_bins)
        tokens, _ = decode(built.params, mel)
        texts = built.tokenizer.batch_decode(tokens.cpu().tolist())
        for (name, ci, _), text in zip(batch, texts):
            chunk_texts[name][ci] = text

    pending: list = []

    def drain(full_only=True):
        while len(pending) >= B or (pending and not full_only):
            flush(pending[:B])
            del pending[:B]

    for kind, path in _gather_inputs(ens.inputs):
        if kind == "wav":
            enqueue(pending, path, read_wav(path))
        else:
            reader = Hdf5AudioReader(path)
            try:
                for i in range(0, len(reader), B):
                    for r in reader.read(range(i, min(i + B, len(reader)))):
                        enqueue(pending, f"{path}#{r[0]}", r[1])
                    drain()
            finally:
                reader.close()
        drain()
    drain(full_only=False)

    results = []
    for name in order:
        text = " ".join(t.strip() for t in chunk_texts[name]
                        if t is not None and t.strip())
        results.append({"file": name, "text": text})
        print(f"{name}\t{text}")

    if ens.output:
        with open(ens.output, "w") as f:
            for r in results:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return results


if __name__ == "__main__":
    main()
