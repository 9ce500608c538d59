// Whisper's log-mel frontend, written by hand for Hopper (sm_90a).
//
// Replaces asr_finetune_tpu/ops/logmel_pallas.py `log_mel_pallas` (:123),
// whose pl.pallas_call (:147) runs `_kernel` (:96). Per utterance b of raw
// fp32 audio (B, n_samples) and frame f in [0, 3000) it computes, in fp32 on
// the CUDA cores,
//   x_t   = audio[b, f*160 + t - 200] for t in [0, 400), reflected at both
//           ends (the reflect padding of 200), times the hann window w_t,
//   X_k   = sum_t x_t exp(-2 pi i k t / 400), k in [0, 200], the real DFT,
//   p_k   = re(X_k)^2 + im(X_k)^2,
//   raw   = log10(max(sum_k p_k melfb[k][m], 1e-10)) for the slaney bank,
//   out[b, f, m] = (max(raw, max_b - 8) + 4) / 4, max_b the utterance's
//           largest raw value (Whisper's floor; the JAX package runs it in
//           XLA after its Pallas call).
//
// Bound on the card: bytes. At B = 4, 128 mels the function reads 7.7 MB of
// audio and writes 6.1 MB (0.0041 ms at 3.35 TB/s); as a fast transform
// and a band product it does ~11,400 operations a frame
// (ops/logmel_fused.flops_per_frame), 0.14 GFLOP, 0.002 ms at 67 TFLOP/s.
// What holds it above that is the instructions' issue and the shared-memory
// round trips between passes, not the bytes (PERF.md): each change that cut
// instructions a block (one thread a bin pair of 4 frames, a radix-5
// butterfly of 2 frames, the band loop two bins a step) shortened the call;
// those that only shortened a block's latency did not.
//
// Design. One block of 128 threads takes 4 consecutive frames of one
// utterance (up to 10 blocks an SM at 48 registers):
//   1. it copies the table into shared memory (before griddepcontrol.wait:
//      no kernel writes it) and, after the wait, each of pass 1's threads
//      loads its 16 samples straight into registers in 8-byte pieces (the
//      first and last blocks of an utterance reflect sample by sample);
//   2. the 200-point complex FFT of z_n = x_2n + i x_2n+1 in three Stockham
//      passes through shared memory (ops/logmel_fused.stage_maps): radix 8
//      over Ns = 1 (no twiddles; it windows the samples it holds; a
//      butterfly a thread), radix 5 over Ns = 8 and radix 5 over Ns = 40 (a
//      butterfly of 2 frames a thread, its twiddles read once); the first
//      pass's output lies one float2 apart every 8, so that its writes at a
//      stride of 8 meet few banks twice;
//   3. the real split, one bin pair (k, 200 - k) of the 4 frames a thread:
//      E = (Z_k + conj Z_{200-k}) / 2, O = -i (Z_k - conj Z_{200-k}) / 2,
//      X_k = E + W^k O, X_{200-k} = conj(E - W^k O), W = exp(-2 pi i / 400),
//      the powers stored bin-major (a float4 of 4 frames a bin);
//   4. a thread takes one mel of the 4 frames: it sums the filter's nonzero
//      band in ascending k, two bins a step (the skipped terms are exact
//      zeros; one read of a band value and one float4 serve the 4 frames),
//      takes log10 on the special-function unit (__log10f, a few ulp, far
//      inside the fp32 limits) and, for the whole function, stores y =
//      (x + 4) / 4 of the raw x. The block
//      folds its raw max into the utterance's by an atomic max on the
//      float's order-preserving integer image (exact in any order, so two
//      calls give the same bits) and stores its raw minimum.
// A second launch (programmatic, dependent) lifts y to ((max_b - 8) + 4) / 4
// in the frame blocks whose minimum lies under max_b - 8, which equals
// _normalize's (max(x, max_b - 8) + 4) / 4 bit for bit, as y rounds
// monotonically in x; its last block puts the maxima and its ticket back to
// their idle values, so a captured call replays. Twiddles, the butterflies'
// constants and the window come from one fp32 table the wrapper builds in
// fp64 (ops/logmel_fused.fft_table).
#include "common.cuh"
#include "hopper.cuh"

#include <climits>

using namespace asr;

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int PAD = N_FFT / 2;        // reflect padding on each side
constexpr int N_FRAMES = 3000;        // frames of a 30 s window
constexpr int NZ = N_FFT / 2;         // 200 complex points
constexpr int N_PAIRS = NZ / 2 + 1;   // bin pairs (k, 200 - k), k <= 100
constexpr int FR = 4;                 // frames a block: a float4 of powers a bin
constexpr int THREADS = 128;          // a radix-8 butterfly, a bin pair, a mel each
constexpr int RADIX5_THREADS = 80;    // a radix-5 butterfly of 2 frames each
constexpr int MIN_BLOCKS = 10;        // an SM, at 48 registers
constexpr int SPAN = (FR - 1) * HOP + N_FFT;   // 880 samples a block covers
constexpr int ZA = NZ + NZ / 8;       // the first pass's padded frame (225 float2)
constexpr int MAX_MELS = 128;
// ops/logmel_fused.fft_table's layout (floats)
constexpr int T_TW2 = 8;                        // pass 2: 8 x 4 complex
constexpr int T_TW3 = T_TW2 + 2 * 8 * 4;        // pass 3: 40 x 4 complex
constexpr int T_SPLIT = T_TW3 + 2 * 40 * 4;     // W^k, k <= 100
constexpr int T_WIN = T_SPLIT + 2 * N_PAIRS;    // the window
constexpr int TABLE_FLOATS = (T_WIN + N_FFT + 3) / 4 * 4;
constexpr int FLOOR_THREADS = 1024;           // a warp a frame block
static_assert(FR == 4 && N_FRAMES % FR == 0 && THREADS >= MAX_MELS &&
              THREADS >= FR * (NZ / 8) && THREADS >= N_PAIRS &&
              RADIX5_THREADS * 2 == FR * (NZ / 5), "layout");
static_assert(T_WIN == 594 && TABLE_FLOATS == 996 && TABLE_FLOATS <= 8 * THREADS,
              "ops/logmel_fused.fft_table");

// sample index s of the padded frame row, reflected into [0, n)
__device__ __forceinline__ int reflect(int s, int n) {
  s = s < 0 ? -s : s;
  return s >= n ? 2 * (n - 1) - s : s;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// 4-point forward DFT in place
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 s0 = cadd(a0, a2), d0 = csub(a0, a2), s1 = cadd(a1, a3), d1 = csub(a1, a3);
  a0 = cadd(s0, s1);
  a2 = csub(s0, s1);
  a1 = make_float2(d0.x + d1.y, d0.y - d1.x);   // d0 - i d1
  a3 = make_float2(d0.x - d1.y, d0.y + d1.x);   // d0 + i d1
}

// 8-point forward DFT in place: two 4-point DFTs, W8^k, r2 = sqrt(1/2)
__device__ __forceinline__ void dft8(float2 (&v)[8], float r2) {
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = make_float2(r2 * (o1.x + o1.y), r2 * (o1.y - o1.x));    // W8^1 o1
  o2 = make_float2(o2.y, -o2.x);                               // W8^2 o2 = -i o2
  o3 = make_float2(r2 * (o3.y - o3.x), -r2 * (o3.x + o3.y));   // W8^3 o3
  v[0] = cadd(e0, o0); v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1); v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2); v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3); v[7] = csub(e3, o3);
}

// 5-point forward DFT in place; k = cos 2pi/5, cos 4pi/5, sin 2pi/5, sin 4pi/5
__device__ __forceinline__ void dft5(float2 (&v)[5], const float (&k)[4]) {
  const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
  const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
  const float2 t1 = make_float2(v[0].x + k[0] * a1.x + k[1] * a2.x,
                                v[0].y + k[0] * a1.y + k[1] * a2.y);
  const float2 t2 = make_float2(v[0].x + k[1] * a1.x + k[0] * a2.x,
                                v[0].y + k[1] * a1.y + k[0] * a2.y);
  const float2 u1 = make_float2(k[2] * b1.x + k[3] * b2.x, k[2] * b1.y + k[3] * b2.y);
  const float2 u2 = make_float2(k[3] * b1.x - k[2] * b2.x, k[3] * b1.y - k[2] * b2.y);
  v[0] = cadd(v[0], cadd(a1, a2));
  v[1] = make_float2(t1.x + u1.y, t1.y - u1.x);   // t1 - i u1
  v[4] = make_float2(t1.x - u1.y, t1.y + u1.x);   // t1 + i u1
  v[2] = make_float2(t2.x + u2.y, t2.y - u2.x);
  v[3] = make_float2(t2.x - u2.y, t2.y + u2.x);
}

// a radix-5 pass over Ns points (8 or 40), thread 40 g + j taking
// butterfly j of frames g and g + 2 (one load of its twiddles for both): it
// reads points j + 40 s (at n + n / 8 when the source is pass 1's padded
// layout), multiplies input s > 0 by tw[(j % Ns) * 4 + s - 1] and writes
// output s to point (j / Ns) * 5 Ns + j % Ns + s Ns of dst (natural layout)
template <int NS, bool PADDED>
__device__ __forceinline__ void radix5_pass(const float2* src, float2* dst, const float* table,
                                            const float2* tw) {
  if (threadIdx.x >= RADIX5_THREADS) return;
  const float k[4] = {table[0], table[1], table[2], table[3]};
  const int g = threadIdx.x / (NZ / 5), j = threadIdx.x - g * (NZ / 5), q = j % NS;
  const float2 w[4] = {tw[q * 4], tw[q * 4 + 1], tw[q * 4 + 2], tw[q * 4 + 3]};
#pragma unroll
  for (int f = 0; f < FR * (NZ / 5) / RADIX5_THREADS; ++f) {
    const int i = g + f * (RADIX5_THREADS / (NZ / 5));
    const float2* s = src + i * (PADDED ? ZA : NZ);
    float2 v[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const int n = j + r * (NZ / 5);
      v[r] = s[PADDED ? n + n / 8 : n];
      if (r > 0) v[r] = cmul(v[r], w[r - 1]);
    }
    dft5(v, k);
    float2* d = dst + i * NZ + (j / NS) * 5 * NS + q;
#pragma unroll
    for (int r = 0; r < 5; ++r) d[r * NS] = v[r];
  }
}

// the float's order-preserving integer image, and back
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Timing probe, built only with -DLOGMEL_TRACE (tools/bench_log_mel.py
// --trace): thread 0 of each block of the first 4 utterances stamps its
// entry and exit (globaltimer, ns) and the SM clock at entry and after the
// table's staging (and the wait for the kernel before), pass 1 (and the
// samples' arrival), passes 2 and 3, the split and the band sums
#ifdef LOGMEL_TRACE
constexpr int TRACE_BLOCKS = 4 * (N_FRAMES / FR);
__device__ unsigned long long g_trace[TRACE_BLOCKS][8];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(slot, value)                                                  \
  do {                                                                      \
    if (threadIdx.x == 0 && blockIdx.y < 4)                                 \
      g_trace[blockIdx.y * gridDim.x + blockIdx.x][slot] = (value);         \
  } while (0)
#else
#define TRACE(slot, value)
#endif

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ table,
               const int* __restrict__ bands, const float* __restrict__ band_vals,
               float* __restrict__ out, int* __restrict__ ws, int n_samples, int n_mels) {
  __shared__ __align__(16) float tab[TABLE_FLOATS];   // fft_table
  __shared__ __align__(16) float2 za[FR * ZA];    // pass 1 out (padded), pass 3 out
  __shared__ __align__(16) float2 zb[FR * NZ];    // pass 2 out, then the powers
  __shared__ float red[2 * (THREADS / 32)];

  TRACE(0, global_ns());
  TRACE(2, clock64());
  griddep_launch();   // the floor launch may take SMs as this grid drains
  const int f0 = blockIdx.x * FR, b = blockIdx.y, tid = threadIdx.x;
  const int i1 = tid / (NZ / 8), j1 = tid - i1 * (NZ / 8);   // pass 1's frame, butterfly
  // step 4's mel tid: its band
  int lo = 0, off = 0, end = 0;
  if (tid < n_mels) {
    lo = __ldg(bands + tid);
    off = __ldg(bands + n_mels + tid);
    end = __ldg(bands + n_mels + tid + 1);
  }

  // 1. the table's pieces into registers (it precedes the kernel before),
  //    then, once that kernel has ended, pass 1's samples into registers:
  //    butterfly j of frame i reads samples 2n and 2n + 1 of its frame,
  //    n = j + 25 s, at f0 * HOP - PAD + i * HOP + 2n of the utterance,
  //    reflected at 0 and n_samples - 1 in the first and last blocks; the
  //    table goes to shared memory while the samples are on their way
  float4 tv[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (tid + k * THREADS < TABLE_FLOATS / 4)
      tv[k] = __ldg(reinterpret_cast<const float4*>(table) + tid + k * THREADS);
  griddep_wait();
  const float* a = audio + (long long)b * n_samples;
  const int s0 = f0 * HOP - PAD;
  float2 v[8];
  if (tid < FR * (NZ / 8)) {
    const int t0 = s0 + i1 * HOP + 2 * j1;
    if (s0 >= 0 && s0 + SPAN <= n_samples) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        v[r] = __ldg(reinterpret_cast<const float2*>(a + t0 + r * (NZ / 4)));
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int t = t0 + r * (NZ / 4);
        v[r] = make_float2(a[reflect(t, n_samples)], a[reflect(t + 1, n_samples)]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (tid + k * THREADS < TABLE_FLOATS / 4) reinterpret_cast<float4*>(tab)[tid + k * THREADS] = tv[k];
  __syncthreads();
  TRACE(3, clock64());

  // 2a. pass 1, radix 8 over Ns = 1 (no twiddles): the samples windowed,
  //     output s to point 8 j + s, stored at 9 j + s
  if (tid < FR * (NZ / 8)) {
    const float2* win = reinterpret_cast<const float2*>(tab + T_WIN);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 w = win[j1 + r * (NZ / 8)];
      v[r] = make_float2(v[r].x * w.x, v[r].y * w.y);
    }
    dft8(v, tab[4]);
    float2* d = za + i1 * ZA + 9 * j1;
#pragma unroll
    for (int r = 0; r < 8; ++r) d[r] = v[r];
  }
  __syncthreads();
  TRACE(4, clock64());

  // 2b. pass 2, radix 5 over Ns = 8, from the padded layout; 2c. pass 3,
  //     radix 5 over Ns = 40: natural order into za
  radix5_pass<8, true>(za, zb, tab, reinterpret_cast<const float2*>(tab + T_TW2));
  __syncthreads();
  radix5_pass<40, false>(zb, za, tab, reinterpret_cast<const float2*>(tab + T_TW3));
  __syncthreads();
  TRACE(5, clock64());

  // 3. the real split: thread k takes bin pair (k, 200 - k) of the 4
  //    frames and stores p_k and p_{200-k} bin-major (the 4 frames' powers
  //    of a bin are one float4)
  float* pw = reinterpret_cast<float*>(zb);
  if (tid < N_PAIRS) {
    const int k = tid, kc = k == 0 ? 0 : NZ - k;
    const float2 w = reinterpret_cast<const float2*>(tab + T_SPLIT)[k];
    float hi4[FR], lo4[FR];
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      const float2 zk = za[i * NZ + k], zc = za[i * NZ + kc];
      const float2 e = make_float2((zk.x + zc.x) * 0.5f, (zk.y - zc.y) * 0.5f);
      const float2 o = make_float2((zk.y + zc.y) * 0.5f, (zc.x - zk.x) * 0.5f);
      const float2 t = cmul(w, o);
      const float2 hi = cadd(e, t), lo = csub(e, t);
      hi4[i] = hi.x * hi.x + hi.y * hi.y;
      lo4[i] = lo.x * lo.x + lo.y * lo.y;
    }
    float4* p4 = reinterpret_cast<float4*>(pw);
    p4[k] = make_float4(hi4[0], hi4[1], hi4[2], hi4[3]);
    if (k != NZ / 2) p4[NZ - k] = make_float4(lo4[0], lo4[1], lo4[2], lo4[3]);
  }
  __syncthreads();
  TRACE(6, clock64());

  // 4. the band sums, log10, the block's extremes: thread m takes mel m of
  //    the 4 frames (one read of a band value and one float4 of powers a
  //    bin); normalizing, it stores (x + 4) / 4 of the raw x, and the floor
  //    launch lifts what lies under max - 8
  float mx = NEG, mn = -NEG;
  if (tid < n_mels) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* pb = reinterpret_cast<const float4*>(pw) + lo - off;
    int t = off;
    for (; t + 1 < end; t += 2) {
      const float w0 = __ldg(band_vals + t), w1 = __ldg(band_vals + t + 1);
      const float4 p0 = pb[t], p1 = pb[t + 1];
      acc.x = fmaf(p1.x, w1, fmaf(p0.x, w0, acc.x));
      acc.y = fmaf(p1.y, w1, fmaf(p0.y, w0, acc.y));
      acc.z = fmaf(p1.z, w1, fmaf(p0.z, w0, acc.z));
      acc.w = fmaf(p1.w, w1, fmaf(p0.w, w0, acc.w));
    }
    if (t < end) {
      const float w = __ldg(band_vals + t);
      const float4 p = pb[t];
      acc.x = fmaf(p.x, w, acc.x);
      acc.y = fmaf(p.y, w, acc.y);
      acc.z = fmaf(p.z, w, acc.z);
      acc.w = fmaf(p.w, w, acc.w);
    }
    const float v[4] = {__log10f(fmaxf(acc.x, 1e-10f)), __log10f(fmaxf(acc.y, 1e-10f)),
                        __log10f(fmaxf(acc.z, 1e-10f)), __log10f(fmaxf(acc.w, 1e-10f))};
    float* o = out + ((long long)b * N_FRAMES + f0) * n_mels + tid;
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      o[i * n_mels] = ws != nullptr ? (v[i] + 4.f) / 4.f : v[i];
      mx = fmaxf(mx, v[i]);
      mn = fminf(mn, v[i]);
    }
  }
  if (ws != nullptr) {
    mx = warp_max(mx);
    mn = -warp_max(-mn);
    if ((tid & 31) == 0) {
      red[tid >> 5] = mx;
      red[THREADS / 32 + (tid >> 5)] = mn;
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) {
        mx = fmaxf(mx, red[w]);
        mn = fminf(mn, red[THREADS / 32 + w]);
      }
      atomicMax(ws + 1 + b, ordered(mx));
      ws[1 + gridDim.y + b * gridDim.x + blockIdx.x] = __float_as_int(mn);
    }
  }
  TRACE(7, clock64());
  TRACE(1, global_ns());
}

// Whisper's floor over out, which holds y = (x + 4) / 4 of the raw x:
// out = max(y, ((max_b - 8) + 4) / 4), bit for bit _normalize's (max(x,
// max_b - 8) + 4) / 4, as (x + 4) / 4 rounds monotonically. A warp takes a
// frame block of log_mel_kernel and touches it only if its raw minimum lies
// under max_b - 8. ws = [ticket, max images (B), raw minima (B x 3000 / FR)];
// the grid's last block puts the ticket and the maxima back. A programmatic
// dependent launch: it waits for log_mel_kernel's end before it reads.
__global__ void __launch_bounds__(FLOOR_THREADS)
log_mel_floor_kernel(float* __restrict__ out, int* __restrict__ ws, int B, int n_mels) {
  griddep_launch();   // the next kernel in the stream may take SMs as this grid drains
  griddep_wait();
  constexpr int NBLK = N_FRAMES / FR;
  const int g = blockIdx.x * (FLOOR_THREADS / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (g < B * NBLK) {
    const int b = g / NBLK;
    const float c = unordered(__ldcg(ws + 1 + b)) - 8.f;
    if (__int_as_float(__ldcg(ws + 1 + B + g)) < c) {
      const float fl = (c + 4.f) / 4.f;
      float4* o = reinterpret_cast<float4*>(out + (long long)g * FR * n_mels);
      for (int e = lane; e < FR * n_mels / 4; e += 32) {
        float4 v = o[e];
        v.x = fmaxf(v.x, fl);
        v.y = fmaxf(v.y, fl);
        v.z = fmaxf(v.z, fl);
        v.w = fmaxf(v.w, fl);
        o[e] = v;
      }
    }
  }
  __syncthreads();   // every warp of the block has read (and used) its maximum
  if (threadIdx.x == 0) {
    if (atomicAdd(ws, 1) == static_cast<int>(gridDim.x) - 1) {
      for (int b = 0; b < B; ++b) ws[1 + b] = INT_MIN;
      ws[0] = 0;
    }
  }
}

// a programmatic dependent launch: it may start before the kernel before it
// in the stream ends, and waits for it with griddepcontrol.wait
template <typename Kernel, typename... Args>
cudaError_t launch_pdl(Kernel kernel, dim3 grid, int threads, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// audio (B, n_samples) fp32, 16-byte aligned; table: fft_table, n_table
// floats; bands int32 [lo (n_mels), off (n_mels + 1)], band_vals fp32; out
// (B, 3000, n_mels) fp32. ws: int32, log_mel_workspace_ints(B) of them,
// [ticket 0, B maxima at INT_MIN, raw minima], or null for the log10 mel
// power alone (one launch, unclamped); else two launches, the second the
// floor. n_samples >= 3000 x 160, n_mels <= 128.
extern "C" int log_mel_fwd(const void* audio, const void* table, const void* bands,
                           const void* band_vals, void* out, void* ws, int B, int n_samples,
                           int n_mels, int n_table, void* stream) {
  if (n_mels < 1 || n_mels > MAX_MELS || n_samples < N_FRAMES * HOP || n_samples % 4 != 0 ||
      B < 1 || n_table != TABLE_FLOATS || (reinterpret_cast<uintptr_t>(audio) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_pdl(log_mel_kernel, dim3(N_FRAMES / FR, B), THREADS, s,
                             static_cast<const float*>(audio), static_cast<const float*>(table),
                             static_cast<const int*>(bands), static_cast<const float*>(band_vals),
                             static_cast<float*>(out), static_cast<int*>(ws), n_samples, n_mels);
  if (e != cudaSuccess || ws == nullptr) return static_cast<int>(e);
  const dim3 grid((B * (N_FRAMES / FR) + FLOOR_THREADS / 32 - 1) / (FLOOR_THREADS / 32));
  return static_cast<int>(launch_pdl(log_mel_floor_kernel, grid, FLOOR_THREADS, s,
                                     static_cast<float*>(out), static_cast<int*>(ws), B, n_mels));
}

// ints of log_mel_fwd's workspace for B utterances
extern "C" int log_mel_workspace_ints(int B) { return 1 + B + B * (N_FRAMES / FR); }

#ifdef LOGMEL_TRACE
// the probe's stamps, TRACE_BLOCKS x 8 unsigned 64-bit (blocks of utterance
// b at b x 3000 / FR + frame block)
extern "C" int log_mel_trace_blocks() { return TRACE_BLOCKS; }
extern "C" int log_mel_trace(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));
}
#endif
