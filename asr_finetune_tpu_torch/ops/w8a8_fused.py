"""W8A8 product: CUDA kernel (csrc/w8a8.cu) + plain version.

Counterpart of asr_finetune_tpu/ops/w8a8_fused.py: replaces the Pallas
kernel `fused_w8a8` (:93; pl.pallas_call :103, `_kernel` :82), the vector-wise
W8A8 product of ops/quant.py `_w8a8_impl` (:324-332). Per row of x (m, K):

    xs = max(amax|x_row * keep|, 1e-8) * f32(1/127)
    x8 = clip(round_half_even((x_row * keep) / xs), -127, 127)
    y  = ((float(x8 @ w_q8) * xs) * w_scale) [+ addend]

in fp32, rounded once to x's dtype. `keep` (K,) 0/1 and `addend` (m, N)
fp32 are the outlier path's column mask and side product (ops/quant.py).
The JAX source divides amax by the constant 127; XLA compiles that, in a
jitted step and in the Pallas kernel alike, to a multiply by f32(1/127),
which moves xs by one ulp on some rows (and then whole int8 steps), so the
port computes the compiled form. x / xs stays an IEEE division.

Bound on the card: int8 operations at the encoder's m, bytes at the
decoder's; csrc/w8a8.cu says how the kernel is laid out. It equals the plain
version bit for bit: IEEE division, round half to even, the epilogue's
steps rounded one by one. The plain version takes the integer product as a
float64 product of the int8 values, exact while every partial sum stays
below 2^53 (127^2 K is far below it).

The TPU block table `pick_mt` and the ASR_TPU_FUSED_W8A8 opt-in are not
ported: on the card every W8A8 product goes through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _build

# wrapper launches on the card (chip_smoke.py reads them)
LAUNCHES = {"w8a8": 0}
INV_127 = float(np.float32(1.0) / np.float32(127.0))   # XLA's constant for x / 127
TILE, SLICE = 128, 64        # the kernel's output tile (rows and columns) and K slice
SLICES_PER_SPLIT = 4         # the least K slices a split-K range takes


def reset_launches() -> None:
    LAUNCHES["w8a8"] = 0


def w8a8_plain(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
               keep: Optional[torch.Tensor] = None,
               addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (m, K) float, w_q8 (K, N)
    int8, w_scale (N,) or (1, N) fp32 → (m, N) in x's dtype."""
    x32 = x.float()
    if keep is not None:
        x32 = x32 * keep.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    xs = torch.clamp(amax, min=1e-8) * INV_127
    x8 = torch.clamp(torch.round(x32 / xs), -127, 127)
    y32 = torch.matmul(x8.double(), w_q8.double())       # exact integers
    y = y32.float() * xs * w_scale.reshape(-1).float()
    if addend is not None:
        y = y + addend
    return y.to(x.dtype)


def w8a8(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
         keep: Optional[torch.Tensor] = None,
         addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 product of x (m, K) with w_q8 (K, N) int8 and its per-column
    scales. CUDA tensors launch the kernel (or raise); CPU tensors take
    w8a8_plain."""
    if x.device.type == "cpu":
        return w8a8_plain(x, w_q8, w_scale, keep, addend)
    return _w8a8_cuda(x, w_q8, w_scale, keep, addend)


def _operand(t: Optional[torch.Tensor], dtype, shape, device, what: str):
    if t is None:
        return None
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"w8a8: {what} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def splits_for(m: int, K: int, N: int, sms: int) -> int:
    """How many ranges the kernel cuts the 64-deep K slices into: 1 when the
    (m, N) tiles of 128 x 128 fill the card's SMs twice over (2 blocks fit
    an SM), else enough ranges to, each at least SLICES_PER_SPLIT deep."""
    tiles = -(-m // TILE) * -(-N // TILE)
    slices = -(-K // SLICE)
    if tiles >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // tiles), slices // SLICES_PER_SPLIT))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _w8a8_cuda(x, w_q8, w_scale, keep, addend):
    if x.dim() != 2 or w_q8.dim() != 2:
        raise ValueError("w8a8: x (m, K) and w_q8 (K, N) must be 2-D")
    m, K = x.shape
    N = w_q8.shape[1]
    dev = x.device
    x_p = _operand(x, x.dtype, (m, K), dev, "x")
    w_p = _operand(w_q8, torch.int8, (K, N), dev, "w_q8")
    s_p = _operand(w_scale.reshape(-1), torch.float32, (N,), dev, "w_scale")
    k_p = _operand(keep, torch.float32, (K,), dev, "keep")
    a_p = _operand(addend, torch.float32, (m, N), dev, "addend")
    mp, kp = -(-m // TILE) * TILE, -(-K // SLICE) * SLICE
    splits = splits_for(m, K, N, _sm_count(dev.index if dev.index is not None
                                           else torch.cuda.current_device()))
    xs = torch.empty((mp,), dtype=torch.float32, device=dev)
    x8 = torch.empty((mp, kp), dtype=torch.int8, device=dev)
    partial = (torch.empty((splits, m, N), dtype=torch.int32, device=dev)
               if splits > 1 else None)
    y = torch.empty((m, N), dtype=x.dtype, device=dev)
    lib = _lib()
    err = lib.w8a8_fwd(_build.dtype_code(x), x_p, w_p, s_p, k_p, a_p, xs.data_ptr(),
                       x8.data_ptr(), None if partial is None else partial.data_ptr(),
                       y.data_ptr(), m, K, N, splits, _build.stream_ptr(x))
    _build.check(lib, err, "w8a8")
    LAUNCHES["w8a8"] += 1
    return y


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("w8a8")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.w8a8_fwd.argtypes = [I] + [P] * 9 + [I, I, I, I, P]
        lib.w8a8_fwd.restype = I
        _LIB = lib
    return _LIB
