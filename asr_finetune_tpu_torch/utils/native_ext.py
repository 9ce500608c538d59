"""ctypes binding of the port's host C++ path (csrc/asr_native.cpp).

Counterpart of asr_finetune_tpu/utils/native_ext.py, with the same three
calls: `edit_distance_words` and `corpus_wer` (evaluation/wer.py) and
`assemble_batch` (data/collator.py). The library is built at first use:

    g++ -O3 -std=c++17 -fPIC -shared -o build/torch_native/asr_native-<hash>.so
        csrc/asr_native.cpp -lpthread

into `build/torch_native/` at the root of the checkout (git-ignored), keyed
by a hash of the source, the compiler and the flags, as ops/_build.py keys
the nvcc builds; `$CXX` names another compiler. It is loaded once, under a
lock: the collator runs in the data pipeline's prefetch thread, so the first
call can come from there. Unlike the JAX package, which falls back to
Python when `make` fails, a failed build or load raises RuntimeError with
the compiler's output: the port never carries on silently on another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, Sequence, Tuple

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "asr_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
# corpus_wer starts a thread for every PAIRS_PER_THREAD pairs, up to
# min(cpu_count, 8): below that, starting a thread costs more than its share
PAIRS_PER_THREAD = 256

_lib = None
_lock = threading.Lock()

_vp = ctypes.c_void_p
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _target() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([_cxx(), *CXX_FLAGS]).encode())
    return BUILD_DIR / f"asr_native-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:   # the compiler is not there
        raise RuntimeError(f"building csrc/asr_native.cpp: {cmd[0]}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed for csrc/asr_native.cpp "
                           f"(exit {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The loaded library, built first if this source and these flags have
    not been built yet; raises RuntimeError when it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            out = _target()
            if not out.exists():
                _build(out)
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                raise RuntimeError(f"loading {out}: {e}") from e
            # the WER calls take their arrays' addresses as plain pointers
            # (no ctypes casts: the evaluator calls them once an utterance)
            lib.edit_distance_u32.restype = ctypes.c_int64
            lib.edit_distance_u32.argtypes = [_vp, ctypes.c_int64, _vp, ctypes.c_int64]
            lib.corpus_wer_u32.restype = ctypes.c_int64
            lib.corpus_wer_u32.argtypes = [_vp, _vp, _vp, _vp, ctypes.c_int64,
                                           ctypes.c_int64, _i64p]
            lib.assemble_batch_f32.restype = None
            lib.assemble_batch_f32.argtypes = [ctypes.POINTER(_f32p), _i64p,
                                               ctypes.c_int64, ctypes.c_int64,
                                               _f32p, ctypes.c_int64]
            _lib = lib
        return _lib


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(os.cpu_count() or 1, 8)


def _wer_threads(n_threads: int, n_pairs: int) -> int:
    """Threads for corpus_wer: at most one per PAIRS_PER_THREAD pairs, so the
    small calls (one utterance, one eval batch) run inline on the calling
    thread instead of starting and joining a pool for microseconds of work."""
    by_work = n_pairs // PAIRS_PER_THREAD
    return 1 if by_work <= 1 else min(_threads(n_threads), by_work)


def _intern(words: Sequence[str], table: Dict[str, int]) -> np.ndarray:
    return np.fromiter((table.setdefault(w, len(table)) for w in words), np.uint32,
                       len(words))


def _intern_packed(texts: Sequence[str], table: Dict[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The whitespace-split words of all texts as one id stream, and the
    prefix offsets of each text's words in it."""
    split = [t.split() for t in texts]
    ids = np.fromiter((table.setdefault(w, len(table)) for ws in split for w in ws),
                      np.uint32)
    off = np.zeros(len(split) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, split), np.int64, len(split)), out=off[1:])
    return ids, off


def edit_distance_words(ref_words: Sequence[str], hyp_words: Sequence[str]) -> int:
    """Word-level Levenshtein distance (S + D + I with unit costs)."""
    lib = load()
    table: Dict[str, int] = {}
    a = _intern(ref_words, table)
    b = _intern(hyp_words, table)
    return int(lib.edit_distance_u32(a.ctypes.data, len(a), b.ctypes.data, len(b)))


def corpus_wer(references: Sequence[str], hypotheses: Sequence[str],
               n_threads: int = 0) -> Tuple[int, int]:
    """(total_errors, total_ref_words) over whitespace-split pairs, in one
    call fanned out over min(cpu_count, 8) threads (n_threads if > 0), at
    most one per PAIRS_PER_THREAD pairs."""
    lib = load()
    table: Dict[str, int] = {}
    refs, ref_off = _intern_packed(references, table)
    hyps, hyp_off = _intern_packed(hypotheses, table)
    total_words = ctypes.c_int64(0)
    errors = lib.corpus_wer_u32(refs.ctypes.data, ref_off.ctypes.data,
                                hyps.ctypes.data, hyp_off.ctypes.data, len(ref_off) - 1,
                                _wer_threads(n_threads, len(ref_off) - 1),
                                ctypes.byref(total_words))
    return int(errors), int(total_words.value)


def assemble_batch(audios: Sequence[np.ndarray], target_len: int,
                   n_threads: int = 1) -> np.ndarray:
    """Waveforms padded with zeros or trimmed to a (B, target_len) float32
    batch, inline on the calling thread unless n_threads > 1 (0: min(cpu_count,
    8)). A batch is a few memcpy of 1.9 MB rows; the collator calls it in the
    prefetch thread, where a pool of its own would compete with the thread
    that dispatches the device's work."""
    lib = load()
    n = len(audios)
    out = np.empty((n, target_len), np.float32)
    # the contiguous float32 copies live in `arrs` until the call returns
    arrs = [np.ascontiguousarray(a, np.float32) for a in audios]
    ptrs = (_f32p * n)(*[a.ctypes.data_as(_f32p) for a in arrs])
    lens = np.asarray([len(a) for a in arrs], np.int64)
    lib.assemble_batch_f32(ptrs, lens.ctypes.data_as(_i64p), n, target_len,
                           out.ctypes.data_as(_f32p), _threads(n_threads))
    return out
