// Whisper's log-mel frontend up to the log, written by hand for Hopper
// (sm_90a).
//
// Replaces asr_finetune_tpu/ops/logmel_pallas.py `log_mel_pallas` (:123),
// whose pl.pallas_call (:147) runs `_kernel` (:96). Per utterance b of raw
// fp32 audio (B, n_samples) and frame f in [0, 3000) it computes, in fp32 on
// the CUDA cores (no TF32, no tensor cores: log10 of small powers would move
// by more than the 1e-4 the port is held to),
//   x_t   = audio[b, f*160 + t - 200] for t in [0, 400), reflected at both
//           ends (the reflect padding of 200),
//   re_k  = sum_t x_t dft[t][k], im_k = sum_t x_t dft[t][224 + k]: the
//           hann-windowed 400-tap real DFT (dft holds cos | -sin, 201 bins
//           each, zero-padded to 224),
//   p_k   = re_k^2 + im_k^2,
//   out[b, f, m] = log10(max(sum_k p_k melfb[k][m], 1e-10)) for the slaney
//           filter bank melfb (201, n_mels).
// The global (max - 8) floor and (x + 4) / 4 run outside in PyTorch, as the
// JAX package runs them in XLA outside its Pallas call.
//
// Bound on the card: operations. At B = 4, 128 mels the DFT and the mel
// projection are 4 x 3000 x (400 x 402 x 2 + 201 x 128 x 2) = 4.5 GFLOP of
// fp32, 0.067 ms at 67 TFLOP/s, against 7.7 MB of audio in and 6.1 MB out
// (0.004 ms at 3.35 TB/s).
//
// Design. The TPU kernel stages four hops per 640-wide row and folds the
// four frame phases into zero-padded DFT operands, to keep Mosaic's lane
// slices aligned; none of that is needed here. One block of 256 threads
// takes 32 consecutive frames of one utterance:
//   1. it stages the 32 x 160 + 240 samples those frames cover in shared
//      memory, reflecting at the ends as it loads;
//   2. it runs the DFT as a product of the (implicit, overlapping) 32 x 400
//      frame matrix with the 400 x 448 table, 16 table rows at a time staged
//      in shared memory (the table, 717 KB, stays in the L2): thread
//      (warp w, lane l) holds re and im of frames 4w..4w+3 at bins
//      l + 32j, j < 7, in 56 registers; a frame's samples are one
//      shared-memory broadcast per warp, a table row a conflict-free read;
//   3. it writes the 32 x 224 power rows over the table tile and projects
//      them on the filter bank (read through the L1 from the L2), each
//      thread 4 frames x up to 4 mel bins, and stores log10.
// A simple kernel that is right; the DFT's shared-memory reads (18 per 56
// FMAs) bound it, not the FMA rate.
#include "common.cuh"

using namespace asr;

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int PAD = N_FFT / 2;        // reflect padding on each side
constexpr int N_FRAMES = 3000;        // frames of a 30 s window
constexpr int N_BINS = N_FFT / 2 + 1; // 201
constexpr int BIN_PAD = 224;          // 7 x 32: bins of one table half, zero-padded
constexpr int FR = 32;                // frames per block
constexpr int KT = 16;                // table rows per staged tile
constexpr int THREADS = 256;          // 8 warps x 4 frames
constexpr int SPAN = FR * HOP + N_FFT - HOP;           // samples a block's frames cover
constexpr int TILE = KT * 2 * BIN_PAD;                 // floats of one table tile
constexpr int POW = FR * BIN_PAD;                      // floats of the power rows
constexpr int BUF = TILE > POW ? TILE : POW;
constexpr size_t SMEM_BYTES = sizeof(float) * (SPAN + BUF);
constexpr int MAX_MELS = 128;
constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ dft,
               const float* __restrict__ melfb, float* __restrict__ out, int n_samples,
               int n_mels) {
  extern __shared__ float smem[];
  float* xs = smem;          // the block's samples, reflected
  float* buf = smem + SPAN;  // a table tile, then the power rows

  const int f0 = blockIdx.x * FR, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* a = audio + (long long)b * n_samples;

  // 1. the samples of frames f0 .. f0 + FR - 1: padded index p is sample
  //    p - PAD, reflected at 0 and at n_samples - 1 (a last block's frames
  //    past N_FRAMES read clamped samples and store nothing)
  for (int i = tid; i < SPAN; i += THREADS) {
    int s = f0 * HOP + i - PAD;
    if (s < 0) s = -s;
    if (s >= n_samples) s = 2 * (n_samples - 1) - s;
    s = s < 0 ? 0 : (s >= n_samples ? n_samples - 1 : s);
    xs[i] = a[s];
  }

  // 2. the DFT: re/im of frames 4 warp + i at bins lane + 32 j
  float re[4][7], im[4][7];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) re[i][j] = im[i][j] = 0.f;
  const float* xw = xs + 4 * warp * HOP;
  for (int t0 = 0; t0 < N_FFT; t0 += KT) {
    __syncthreads();  // the samples are staged; the previous tile is read
    for (int i = tid; i < TILE / 4; i += THREADS)
      reinterpret_cast<float4*>(buf)[i] =
          reinterpret_cast<const float4*>(dft + (long long)t0 * 2 * BIN_PAD)[i];
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < KT; ++tt) {
      const int t = t0 + tt;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = xw[i * HOP + t];
      const float* row = buf + tt * 2 * BIN_PAD + lane;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const float c = row[32 * j], s = row[BIN_PAD + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          re[i][j] = fmaf(x[i], c, re[i][j]);
          im[i][j] = fmaf(x[i], s, im[i][j]);
        }
      }
    }
  }

  // 3. power rows over the last tile, then the mel projection and log10
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j)
      buf[(4 * warp + i) * BIN_PAD + lane + 32 * j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* pw = buf + 4 * warp * BIN_PAD;
  for (int k = 0; k < N_BINS; ++k) {
    float fb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = lane + 32 * j;
      fb[j] = m < n_mels ? __ldg(melfb + k * n_mels + m) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = pw[i * BIN_PAD + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, fb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + 4 * warp + i;
    if (f >= N_FRAMES) continue;
    float* o = out + ((long long)b * N_FRAMES + f) * n_mels;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = lane + 32 * j;
      if (m < n_mels) o[m] = log10f(fmaxf(acc[i][j], 1e-10f));
    }
  }
}

}  // namespace

// audio (B, n_samples) fp32; dft (400, 448) fp32, cos | -sin of the
// hann-windowed real DFT, each half zero-padded from 201 to 224 bins; melfb
// (201, n_mels) fp32; out (B, 3000, n_mels) fp32 log10 mel power, unclamped.
// n_samples >= 3000 x 160 (the window the frames cover), n_mels <= 128.
extern "C" int log_mel_fwd(const void* audio, const void* dft, const void* melfb, void* out,
                           int B, int n_samples, int n_mels, void* stream) {
  if (n_mels < 1 || n_mels > MAX_MELS || n_samples < N_FRAMES * HOP || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES || !done[dev]) {
    e = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEVICES) done[dev] = true;
  }
  const dim3 grid((N_FRAMES + FR - 1) / FR, B);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(dft),
      static_cast<const float*>(melfb), static_cast<float*>(out), n_samples, n_mels);
  return static_cast<int>(cudaGetLastError());
}
