// W8A8 matrix product, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_w8a8` of asr_finetune_tpu/ops/w8a8_fused.py
// (:93, pl.pallas_call :103, kernel `_kernel` :82) and computes the W8A8
// product of asr_finetune_tpu/ops/quant.py `_w8a8_impl` (:324-332), for each
// row of x (m, K) against an int8 weight (K, N) with fp32 per-column scales:
//
//     xs = max(amax|x_row * keep|, 1e-8) * f32(1/127)
//     x8 = clip(round_half_even((x_row * keep) / xs), -127, 127)
//     y  = ((float(x8 @ w_q8) * xs) * w_scale) [+ addend]
//
// rounded once to x's dtype (bf16 or fp32). (The JAX source divides by the
// constant 127; XLA compiles that to a multiply by f32(1/127), in the jitted
// step and the Pallas kernel alike, and so does this kernel.) keep (K,) fp32 0/1 is the
// outlier path's column keep-mask and addend (m, N) fp32 its side product;
// both are optional.
//
// Bound on the card: operations at the encoder's m (2 m K N int8 ops against
// (m K + K N + m N) elements: ~9.9 us for 6000 x 1280 x 1280 at 1,979 TOPS),
// bytes at the decoder's m = 768. The TPU kernel quantizes a whole (mt, K)
// row panel in VMEM; at K = 5120 a 128-row int8 panel is 640 KB, more than
// an SM's 227 KB. So x is quantized once, in a pass of its own:
//
//  * quantize_rows_kernel: one block per row reads the row twice (amax, then
//    the quantized values) and writes its fp32 scale xs and the int8 row into
//    a (Mp, Kp) copy padded with zeros to whole 128 x 64 tiles.
//  * w8a8_gemm_kernel: a 128 x 128 output tile per block of 8 warps (each a
//    64 x 32 sub-tile) over a range of 64-deep K slices. A 3-stage cp.async
//    ring keeps two slices' x8 and raw w tiles in flight while the tensor
//    cores work on the current one. Half the block transposes each raw w
//    tile in registers to (n, k) bytes, the layout of an m16n8k32 B fragment,
//    so ldmatrix reads both operands' fragments. mma.sync.m16n8k32 s8 x s8 ->
//    s32; the int32 sum is exact.
//  * When the (m, N) tiles alone would not fill the card twice over (the
//    decoder's m = 768), the K slices are split over blockIdx.z: each split
//    writes its int32 partial sums and w8a8_epilogue_kernel adds them (exact,
//    in any order) before the scales. Otherwise the GEMM applies them itself.
//
// Bit-exact numerics: IEEE division for x / xs (__fdiv_rn, never x * (1/xs)),
// round half to even (rintf), and the epilogue's multiplies and add in the
// order written with __fmul_rn / __fadd_rn, so no FMA contraction merges
// them. The result then equals the plain version (ops/w8a8_fused.w8a8_plain)
// bit for bit. The product is mma.sync, not wgmma/TMA.
#include "common.cuh"

using namespace asr;

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int QTHREADS = 128;   // the quantize pass: threads a row
constexpr int LDS = BK + 16;   // bytes per shared row: 20 words, conflict-free fragment reads
constexpr int STAGES = 3;      // the cp.async ring: slices in shared memory at once
constexpr int A_STAGE = BM * LDS, W_STAGE = BK * BN;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + W_STAGE) + BN * LDS;   // 64 KB

// a row's 8 consecutive values as float, zero past K; vec: 16-byte aligned
// vector loads are allowed for every row (K % 8 == 0, x aligned)
template <typename T>
__device__ __forceinline__ void load8_row(const T* row, int k, int K, bool vec, float (&v)[8]) {
  if (vec && k + 8 <= K) {
    load8(row + k, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = k + i < K ? to_f(row[k + i]) : 0.f;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ int quantize(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// x (m, K) → xs (m,) and x8 (Mp, Kp): rows past m and columns past K are 0.
// One block of QTHREADS per row; the second read of the row hits L1.
template <typename T>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ keep,
                     float* __restrict__ xs, int8_t* __restrict__ x8, int m, int K, int Kp,
                     bool vec) {
  __shared__ float red[QTHREADS / 32];
  const int row = blockIdx.x;
  int8_t* dst = x8 + (long long)row * Kp;
  if (row >= m) {
    for (int k = threadIdx.x * 8; k < Kp; k += QTHREADS * 8)
      *reinterpret_cast<uint2*>(dst + k) = make_uint2(0, 0);
    return;
  }
  const T* xr = x + (long long)row * K;
  float amax = 0.f;
  for (int k = threadIdx.x * 8; k < K; k += QTHREADS * 8) {
    float v[8];
    load8_row(xr, k, K, vec, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float kv = keep == nullptr ? v[i] : (k + i < K ? v[i] * keep[k + i] : 0.f);
      amax = fmaxf(amax, fabsf(kv));
    }
  }
  amax = block_reduce<true>(amax, red);
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  if (threadIdx.x == 0) xs[row] = s;
  for (int k = threadIdx.x * 8; k < Kp; k += QTHREADS * 8) {
    float v[8];
    load8_row(xr, k, K, vec, v);
    int q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float kv = keep == nullptr ? v[i] : (k + i < K ? v[i] * keep[k + i] : 0.f);
      q[i] = quantize(kv, s);
    }
    *reinterpret_cast<uint2*>(dst + k) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(int8_t* smem, const int8_t* gmem, int src_bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 16-byte chunk c of row r of a raw w stage sits at chunk c ^ ((r / 4) % 8),
// so that the 8 lanes of a quarter-warp in transpose_w, rows 4 kb apart, read
// 8 different chunks
__device__ __forceinline__ int w_chunk(int r, int c) { return c ^ ((r >> 2) & 7); }

// Start the copies of one 64-deep slice into a ring stage: the x8 tile
// (128 rows of 64 bytes) and the raw w tile (64 rows of 128 bytes), 2 + 2
// chunks of 16 bytes a thread. Rows of w past K and columns past N read as 0.
// Without vec_w (N % 16 != 0 or w unaligned) the w chunks are gathered byte
// by byte and stored synchronously.
__device__ __forceinline__ void start_slice_copy(int8_t* a_st, int8_t* w_st,
                                            const int8_t* __restrict__ x8,
                                            const int8_t* __restrict__ w, int m0, int n0, int k0,
                                            int K, int Kp, int N, bool vec_w, int tid) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int gid = tid + it * THREADS;
    const int r = gid >> 2, c = gid & 3;
    cp_async16(a_st + r * LDS + c * 16, x8 + (long long)(m0 + r) * Kp + k0 + c * 16, 16);
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int gid = tid + it * THREADS;
    const int r = gid >> 3, c = gid & 7;
    const int k = k0 + r, n = n0 + c * 16;
    int8_t* dst = w_st + r * BN + w_chunk(r, c) * 16;
    const bool in = k < K && n < N;
    if (vec_w) {
      cp_async16(dst, in ? w + (long long)k * N + n : w, in ? 16 : 0);
    } else {
      int b[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = in && n + j < N ? w[(long long)k * N + n + j] : 0;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                     pack4(b[8], b[9], b[10], b[11]), pack4(b[12], b[13], b[14], b[15]));
    }
  }
}

// the 4 x 4 bytes wr[i] = w[k + i][n .. n + 3] as 4 words (k .. k + 3) of
// columns n .. n + 3, stored to the transposed tile at dst, dst + LDS, ...
__device__ __forceinline__ void store_transposed(const uint32_t (&wr)[4], uint32_t* dst) {
  const uint32_t t0 = __byte_perm(wr[0], wr[1], 0x5140), t1 = __byte_perm(wr[0], wr[1], 0x7362);
  const uint32_t t2 = __byte_perm(wr[2], wr[3], 0x5140), t3 = __byte_perm(wr[2], wr[3], 0x7362);
  dst[0] = __byte_perm(t0, t2, 0x5410);
  dst[LDS / 4] = __byte_perm(t0, t2, 0x7632);
  dst[2 * LDS / 4] = __byte_perm(t1, t3, 0x5410);
  dst[3 * LDS / 4] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Warps 0-3: the raw w stage (k, n) → b_s (n, k), the layout of an
// m16n8k32 B fragment. A thread takes rows 4 kb .. 4 kb + 3 of 16 columns.
__device__ __forceinline__ void transpose_w(const int8_t* w_st, int8_t* b_s, int tid) {
  const int kb = tid & 15, ng = tid >> 4;
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = kb * 4 + i;
    v[i] = *reinterpret_cast<const uint4*>(w_st + r * BN + w_chunk(r, ng) * 16);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t wr[4] = {word(v[0], c), word(v[1], c), word(v[2], c), word(v[3], c)};
    store_transposed(wr, reinterpret_cast<uint32_t*>(b_s + (ng * 4 + c) * 4 * LDS + kb * 4));
  }
}

// four 8 x 16-byte matrices of shared memory, one row address a lane
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// (float(acc) * xs) * w_scale [+ addend], each step rounded alone
template <typename T>
__device__ __forceinline__ T scale_out(int acc, float s, float ws, const float* addend,
                                       long long o) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s), ws);
  if (addend != nullptr) v = __fadd_rn(v, addend[o]);
  return from_f<T>(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// partial == nullptr: write y; else write this split's int32 sums to
// partial[blockIdx.z] (m, N)
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_gemm_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ addend,
                 const float* __restrict__ xs, T* __restrict__ y, int* __restrict__ partial,
                 int m, int K, int Kp, int N, int slices_per_split, bool vec_w) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* a_ring = smem;                          // STAGES x8 tiles: (row, k)
  int8_t* w_ring = smem + STAGES * A_STAGE;       // STAGES raw w tiles: (k, n), swizzled
  int8_t* b_s = w_ring + STAGES * W_STAGE;        // the w tile, transposed: (n, k)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int k_begin = blockIdx.z * slices_per_split * BK;
  const int n_slices = (min(Kp, k_begin + slices_per_split * BK) - k_begin) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // STAGES - 1 slices in flight ahead of the one in use; every iteration
  // commits one group (empty past the last slice), so wait_group counts hold
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_slices)
      start_slice_copy(a_ring + t * A_STAGE, w_ring + t * W_STAGE, x8, w, m0, n0, k_begin + t * BK,
                  K, Kp, N, vec_w, tid);
    cp_async_commit();
  }
  for (int t = 0; t < n_slices; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of slice t have landed
    __syncthreads();               // everyone's have; slice t - 1's fragments are read
    const int ahead = t + STAGES - 1, st = t % STAGES;
    if (ahead < n_slices)
      start_slice_copy(a_ring + (ahead % STAGES) * A_STAGE, w_ring + (ahead % STAGES) * W_STAGE, x8, w,
                  m0, n0, k_begin + ahead * BK, K, Kp, N, vec_w, tid);
    cp_async_commit();
    if (tid < THREADS / 2) transpose_w(w_ring + st * W_STAGE, b_s, tid);
    __syncthreads();
    const int8_t* a_s = a_ring + st * A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // A (row, k) and B (n, k) fragments of m16n8k32 s8 are those of
      // m16n8k16 b16 byte for byte, so ldmatrix loads them
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_s + (wm + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn + (j + (lane >> 4)) * 8 + (lane & 7)) * LDS + kk +
                           ((lane >> 3) & 1) * 16);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }

  // two adjacent columns a lane: one paired store when both are in range
  // and N is even (the pair is then aligned)
  int* part = partial == nullptr ? nullptr : partial + (long long)blockIdx.z * m * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= m) continue;
      const float s = part == nullptr ? xs[row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + tig * 2;
        const long long o = (long long)row * N + col;
        const int a0 = acc[i][j][h * 2], a1 = acc[i][j][h * 2 + 1];
        if (col + 1 < N && N % 2 == 0) {
          if (part != nullptr) {
            *reinterpret_cast<int2*>(part + o) = make_int2(a0, a1);
          } else {
            store2(y + o, scale_out<T>(a0, s, w_scale[col], addend, o),
                   scale_out<T>(a1, s, w_scale[col + 1], addend, o + 1));
          }
        } else if (col < N) {
          if (part != nullptr) {
            part[o] = a0;
            if (col + 1 < N) part[o + 1] = a1;
          } else {
            y[o] = scale_out<T>(a0, s, w_scale[col], addend, o);
            if (col + 1 < N) y[o + 1] = scale_out<T>(a1, s, w_scale[col + 1], addend, o + 1);
          }
        }
      }
    }
  }
}

// y = the scales applied to the sum of the splits' int32 partials
template <typename T>
__global__ void __launch_bounds__(THREADS)
w8a8_epilogue_kernel(const int* __restrict__ partial, int splits, const float* __restrict__ xs,
                     const float* __restrict__ w_scale, const float* __restrict__ addend,
                     T* __restrict__ y, int m, int N) {
  const long long total = (long long)m * N;
  for (long long o = blockIdx.x * (long long)THREADS + threadIdx.x; o < total;
       o += (long long)gridDim.x * THREADS) {
    int a = 0;
    for (int z = 0; z < splits; ++z) a += partial[z * total + o];
    y[o] = scale_out<T>(a, xs[o / N], w_scale[o % N], addend, o);
  }
}

// the GEMM's 64 KB of dynamic shared memory, allowed once per kernel and
// device (the attribute is per device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <typename T>
cudaError_t w8a8(const void* x, const int8_t* w, const float* w_scale, const float* keep,
                 const float* addend, float* xs, int8_t* x8, int* partial, void* y, int m,
                 int K, int N, int splits, cudaStream_t st) {
  if (m < 1 || K < 1 || N < 1 || splits < 1) return cudaErrorInvalidValue;
  const int Mp = (m + BM - 1) / BM * BM, Kp = (K + BK - 1) / BK * BK;
  const int slices = Kp / BK;
  const int per = (slices + splits - 1) / splits;
  splits = (slices + per - 1) / per;   // no empty split
  const bool vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  quantize_rows_kernel<T><<<Mp, QTHREADS, 0, st>>>(xt, keep, xs, x8, m, K, Kp, vec_x);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(w8a8_gemm_kernel<T>);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, Mp / BM, splits);
  w8a8_gemm_kernel<T><<<grid, THREADS, SMEM_BYTES, st>>>(x8, w, w_scale, addend, xs, yt,
                                                splits > 1 ? partial : nullptr, m, K, Kp, N,
                                                per, vec_w);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long total = (long long)m * N, need = (total + THREADS - 1) / THREADS;
  const int blocks = need < 4096 ? (int)need : 4096;
  w8a8_epilogue_kernel<T><<<blocks, THREADS, 0, st>>>(partial, splits, xs, w_scale, addend, yt,
                                                      m, N);
  return cudaGetLastError();
}

}  // namespace

// C entry. dtype: 0 = float32, 1 = bfloat16 (x and y). w (K, N) int8
// row-major, w_scale (N,) fp32, keep (K,) fp32 or null, addend (m, N) fp32
// or null; x, y, addend contiguous. Scratch: xs (Mp,) fp32, x8 (Mp, Kp)
// int8 (Mp, Kp: m and K rounded up to 128 and 64), and with splits > 1
// partial (splits, m, N) int32. splits: how many ranges the K slices are cut
// into (1: no split).
extern "C" int w8a8_fwd(int dtype, const void* x, const int8_t* w, const float* w_scale,
                        const float* keep, const float* addend, float* xs, int8_t* x8,
                        int* partial, void* y, int m, int K, int N, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0
          ? w8a8<float>(x, w, w_scale, keep, addend, xs, x8, partial, y, m, K, N, splits, st)
          : w8a8<__nv_bfloat16>(x, w, w_scale, keep, addend, xs, x8, partial, y, m, K, N,
                                splits, st));
}
