"""The one traffic generator: a pool of utterances (speech-like audio and a
transcript each) drawn from the seed under a traffic file's parameters.

Every seed gets the same set of sizes: the transcript lengths and the
audio durations are fixed grids over the file's ranges, which the seed
only permutes (and pairs); what the seed draws is the audio's pitch,
syllable rhythm and noise, and the transcripts' letters. So the work of a
window does not depend on the seed.

The pool is written as an audiofolder (16-bit PCM wavs and metadata.csv),
the format the port's data path reads on the card.
"""
from __future__ import annotations

import csv
import os
import wave
from typing import Any, Dict, List

import numpy as np

SAMPLE_RATE = 16_000
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
CTRL = 800          # samples between the pitch and envelope control points
TABLE_BITS = 11
TABLE = 1 << TABLE_BITS   # samples of one cycle of the harmonic wave


class Pool:
    """Utterances as 16-bit samples and transcripts."""

    def __init__(self, pcm: List[np.ndarray], texts: List[str]):
        self.pcm, self.texts = pcm, texts

    def __len__(self) -> int:
        return len(self.texts)

    def audio(self, i: int) -> np.ndarray:
        """Float32 samples in [-1, 1), as a 16-bit wav reads back."""
        return self.pcm[int(i)].astype(np.float32) / 32768.0

    def write(self, folder: str) -> str:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "metadata.csv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["file_name", "transcription"])
            for i, (pcm, text) in enumerate(zip(self.pcm, self.texts)):
                name = f"{i:05d}.wav"
                with wave.open(os.path.join(folder, name), "wb") as wf:
                    wf.setnchannels(1)
                    wf.setsampwidth(2)
                    wf.setframerate(SAMPLE_RATE)
                    wf.writeframes(pcm.astype("<i2").tobytes())
                w.writerow([name, text])
        return folder


def _grid(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def _speech(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """A voiced signal: a wave of 4 harmonics at a pitch that wanders from
    one 50 ms segment to the next, shaped by a syllable envelope with
    pauses, over faint noise; 16-bit."""
    n = int(round(seconds * SAMPLE_RATE))
    m = n // CTRL + 1
    f0 = np.clip(rng.uniform(90, 220) * np.exp(np.cumsum(rng.normal(0, 0.02, m))), 70, 400)
    # the phase in 32-bit fixed point: its top TABLE_BITS bits index the table
    phase = np.cumsum(np.repeat((f0 / SAMPLE_RATE * 2.0 ** 32).astype(np.int64), CTRL)[:n])
    amps = rng.uniform(0.2, 1.0, 4) / np.arange(1, 5)
    ph = 2 * np.pi * np.arange(TABLE) / TABLE
    table = sum(a * np.sin((h + 1) * ph) for h, a in enumerate(amps)).astype(np.float32)
    env = (rng.uniform(0, 1, m) ** 2 * (rng.uniform(0, 1, m) > 0.2)).astype(np.float32)
    x = table[(phase >> (32 - TABLE_BITS)) & (TABLE - 1)] * np.repeat(env, CTRL)[:n]
    x += 0.02 * (rng.random(n, dtype=np.float32) - 0.5)
    x *= 0.5 / max(float(np.abs(x).max()), 1e-9)
    return np.round(x * 32767).astype(np.int16)


def _text(rng: np.random.Generator, n_bytes: int) -> str:
    """n_bytes of lower-case words separated by single spaces."""
    out = bytearray(LETTERS[rng.integers(0, 26, n_bytes)].tobytes())
    pos = 0
    while True:
        pos += int(rng.integers(3, 10))
        if pos >= n_bytes - 1:
            break
        out[pos] = 32
    return out.decode("ascii")


def make_pool(params: Dict[str, Any], seed: int, n: int, stream: int = 0) -> Pool:
    """n utterances: transcripts of the traffic's token range, durations of
    its range in seconds, both as fixed grids the seed permutes."""
    rng = np.random.default_rng([int(seed), stream])
    lo, hi = params["transcript_tokens"]
    lengths = np.round(_grid(lo, hi, n)).astype(int)
    seconds = _grid(*params["audio_seconds"], n)
    lengths, seconds = rng.permutation(lengths), rng.permutation(seconds)
    pcm = [_speech(rng, float(s)) for s in seconds]
    texts = [_text(rng, int(k)) for k in lengths]
    return Pool(pcm, texts)
