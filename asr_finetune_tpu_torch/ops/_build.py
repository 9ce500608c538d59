"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is one shared library with a plain C interface (no
PyTorch headers, so nvcc takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

The output lands in `build/torch_kernels/` at the root of the checkout
(git-ignored), keyed by a hash of the source, every shared header
(`csrc/*.cuh`) and the flags, so an edited source rebuilds and an
unchanged one loads the library already built. The wgmma/TMA kernels
encode their tensor maps on the host at each call with
cuTensorMapEncodeTiled, a driver function they fetch through
cudaGetDriverEntryPoint (csrc/hopper.cuh): no -lcuda, no other flag.
Pointers and the stream pass as `ctypes.c_void_p`; every C entry returns
`cudaGetLastError()` after its launches, which `check` turns into an error.

`build_all()` starts one nvcc per source, all at once, and waits for all of
them: chip_smoke.py uses it so the build time is that of the slowest file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared helpers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Popen of nvcc for csrc/<name>.cu into a temporary file, or None when
    the library for this source is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> None:
    """Compile every csrc/*.cu not yet built, one nvcc each, in parallel."""
    started = {name: _start(name) for name in sources()}
    for name, s in started.items():
        _finish(name, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry of `lib` (every
    source exports `error_string(int)` over cudaGetErrorString)."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    """The C entries' dtype switch: 0 = float32, 1 = bfloat16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]
