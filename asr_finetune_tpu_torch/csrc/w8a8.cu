// W8A8 matrix product, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_w8a8` of asr_finetune_tpu/ops/w8a8_fused.py
// (:93, pl.pallas_call :103, kernel `_kernel` :82) and computes the W8A8
// product of asr_finetune_tpu/ops/quant.py `_w8a8_impl` (:324-332), for each
// row of x (m, K) against an int8 weight with fp32 per-column scales:
//
//     xs = max(amax|x_row * keep|, 1e-8) * f32(1/127)
//     x8 = clip(round_half_even((x_row * keep) / xs), -127, 127)
//     y  = ((float(x8 @ w_q8) * xs) * w_scale) [+ addend]
//
// rounded once to x's dtype (bf16 or fp32). (The JAX source divides by the
// constant 127; XLA compiles that to a multiply by f32(1/127), in the jitted
// step and the Pallas kernel alike, and so does this kernel.) keep (K,) fp32 0/1 is the
// outlier path's column keep-mask and addend (m, N) fp32 its side product;
// both are optional. So is row_amax (m,) fp32: given, it stands for each
// row's amax|x_row * keep| (under tensor parallelism x holds K / tp columns
// and the scale is the whole row's, reduced over the ranks beforehand).
// The weight arrives as w_nk (N, K), the K-major copy of w_q8 (K, N) that
// the int8 base holds beside it (ops/quant.py): 8-bit wgmma reads only
// K-major operands, and the copy is made once, when the base is quantized,
// never per call.
//
// Bound on the card: operations at the encoder's m (2 m K N int8 ops against
// (m K + K N + m N) elements: ~9.9 us for 6000 x 1280 x 1280 at 1,979 TOPS),
// bytes at the decoder's m = 768 (~1.7 us at 1280 x 1280). The TPU kernel
// quantizes a whole (mt, K) row panel in VMEM; at K = 5120 a 128-row int8
// panel is 640 KB, more than an SM's 227 KB. So x is quantized once, in a
// pass of its own, and the product streams K:
//
//  * quantize_rows_kernel: one block of 128 threads per row holds its
//    chunks of the row in registers (as few as K needs, so that many blocks
//    stay resident and their loads in flight), reduces the amax and writes
//    the fp32 scale xs and the int8 row x8 (m, K). Rows longer than 8192
//    take quantize_rows_stream_kernel, which reads the row twice.
//  * w8a8_wgmma_kernel: warp-specialised. A producer warpgroup (one lane
//    issues, the rest give their registers to the consumers) keeps a
//    4-stage ring of 128-byte K slices of x8 and w_nk in flight by TMA
//    (128-byte swizzle, zero-filled past m, N and K); consumer warpgroups
//    of 64 rows run wgmma.m64nNk32.s32.s8.s8 on each slice as it lands and
//    free the previous one. The int32 sum is exact. The tile: 64 x 128
//    (one consumer warpgroup, two blocks an SM) at the decoder's m (768,
//    N 1280: 120 blocks), 128 x 256 (two) where that tile fills half the
//    SMs (the encoder's m, and the decoder's fc1). The epilogue writes the
//    scaled, rounded tile into the drained ring, swizzled, and one thread
//    stores it by TMA: whole lines to memory, the ragged edges clipped by
//    the tensor map. (Stored from registers, 4 bytes a lane at 8 rows a
//    warp, the epilogue took most of the kernel's time.) GEMM and epilogue
//    are one launch, quantize and GEMM two; the GEMM is a programmatic
//    dependent launch: its set-up and its first weight slices overlap the
//    quantize pass, and it waits (griddepcontrol.wait) only before reading
//    x8 and xs.
//  * No split K: cutting the decoder fc2's 40 slices over two ranges (int32
//    partial sums added with red.global.add, the tile's last range applying
//    the epilogue) was slower on an H100 than one range.
//
// Bit-exact numerics: IEEE division for x / xs (__fdiv_rn, never x * (1/xs)),
// round half to even (rintf), and the epilogue's multiplies and add in the
// order written with __fmul_rn / __fadd_rn, so no FMA contraction merges
// them. The result then equals the plain version (ops/w8a8_fused.w8a8_plain)
// bit for bit. The wrapper raises on K % 16 and N % 8 (TMA row pitches).
// A row longer than MAX_K = 8192 (the quantize pass's registers) takes
// quantize_rows_stream_kernel, which reads it twice; the GEMM streams any K
// (the int32 sum stays exact: 127^2 K < 2^31 up to K = 133,000).
#include "common.cuh"
#include "hopper.cuh"

using namespace asr;

namespace {

constexpr int BK = 128;        // K slice (bytes): one 128-byte swizzle atom a row
constexpr int STAGES = 4;
constexpr int QTHREADS = 128;  // the quantize pass: threads a row
constexpr int MAX_K = 8 * 8 * QTHREADS;   // 8 chunks of 8 a thread

// The GEMM's tile: WGS consumer warpgroups of 64 rows each, BN columns, and
// a producer warpgroup.
template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8 + 1024;
  static constexpr int BLOCKS = WGS == 1 ? 2 : 1;   // resident blocks an SM
  // registers a consumer thread claims: what the producer warpgroups give back
  static constexpr int FREE = ((65536 / BLOCKS - PRODUCER_REGS * 128) / CONSUMERS) / 8 * 8;
  static constexpr int REGS = FREE > 232 ? 232 : FREE;
};

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ int quantize(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// x (m, K) → xs (m,) and x8 (m, K), K % 8 == 0, K <= 8 CH QTHREADS. One
// block per row; a thread holds CH chunks of 8 in registers, all loaded
// before any is used. row_amax (m,), when given, is the row's amax: no
// reduction.
template <typename T, int CH>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ keep,
                     const float* __restrict__ row_amax, float* __restrict__ xs,
                     int8_t* __restrict__ x8, int K) {
  __shared__ float red[QTHREADS / 32];
  griddep_launch();
  const int row = blockIdx.x;
  const T* xr = x + (long long)row * K;
  float v[CH][8];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = (threadIdx.x + c * QTHREADS) * 8;
    if (k < K) load8(xr + k, v[c]);
  }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = (threadIdx.x + c * QTHREADS) * 8;
    if (k < K) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (keep != nullptr) v[c][i] *= keep[k + i];
        amax = fmaxf(amax, fabsf(v[c][i]));
      }
    }
  }
  // a uniform branch: the block takes it whole, so the reduction's barriers hold
  amax = row_amax != nullptr ? row_amax[row] : block_reduce<true>(amax, red);
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  if (threadIdx.x == 0) xs[row] = s;
  int8_t* dst = x8 + (long long)row * K;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = (threadIdx.x + c * QTHREADS) * 8;
    if (k < K) {
      int q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = quantize(v[c][i], s);
      *reinterpret_cast<uint2*>(dst + k) =
          make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    }
  }
}

// The same for a row longer than MAX_K (an expert's down-projection, K
// 18944): it does not fit in registers, so the block reads it twice from
// memory (the second pass mostly from the L2), once for the amax (none where
// row_amax is given) and once to quantize, 8 elements a thread at a time.
template <typename T>
__global__ void __launch_bounds__(QTHREADS)
quantize_rows_stream_kernel(const T* __restrict__ x, const float* __restrict__ keep,
                            const float* __restrict__ row_amax, float* __restrict__ xs,
                            int8_t* __restrict__ x8, int K) {
  __shared__ float red[QTHREADS / 32];
  griddep_launch();
  const int row = blockIdx.x;
  const T* xr = x + (long long)row * K;
  float amax = 0.f;
  if (row_amax == nullptr) {   // uniform: the block takes it whole
    for (int k = threadIdx.x * 8; k < K; k += QTHREADS * 8) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (keep != nullptr) v[i] *= keep[k + i];
        amax = fmaxf(amax, fabsf(v[i]));
      }
    }
    amax = block_reduce<true>(amax, red);
  } else {
    amax = row_amax[row];
  }
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  if (threadIdx.x == 0) xs[row] = s;
  int8_t* dst = x8 + (long long)row * K;
  for (int k = threadIdx.x * 8; k < K; k += QTHREADS * 8) {
    float v[8];
    load8(xr + k, v);
    int q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (keep != nullptr) v[i] *= keep[k + i];
      q[i] = quantize(v[i], s);
    }
    *reinterpret_cast<uint2*>(dst + k) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  }
}

template <typename T>
cudaError_t quantize_rows(const T* x, const float* keep, const float* row_amax, float* xs,
                          int8_t* x8, int m, int K, cudaStream_t st) {
  if (K > MAX_K) {
    quantize_rows_stream_kernel<T><<<m, QTHREADS, 0, st>>>(x, keep, row_amax, xs, x8, K);
    return cudaGetLastError();
  }
  const int chunks = (K / 8 + QTHREADS - 1) / QTHREADS;
  if (chunks <= 2)
    quantize_rows_kernel<T, 2><<<m, QTHREADS, 0, st>>>(x, keep, row_amax, xs, x8, K);
  else if (chunks <= 4)
    quantize_rows_kernel<T, 4><<<m, QTHREADS, 0, st>>>(x, keep, row_amax, xs, x8, K);
  else if (chunks <= 5)
    quantize_rows_kernel<T, 5><<<m, QTHREADS, 0, st>>>(x, keep, row_amax, xs, x8, K);
  else
    quantize_rows_kernel<T, 8><<<m, QTHREADS, 0, st>>>(x, keep, row_amax, xs, x8, K);
  return cudaGetLastError();
}

__device__ __forceinline__ void mma_slice(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_ss_s8_n128(d, a, b, 1);
}
__device__ __forceinline__ void mma_slice(int (&d)[128], uint64_t a, uint64_t b) {
  wgmma_ss_s8_n256(d, a, b, 1);
}

// (float(acc) * xs) * w_scale [+ addend], each step rounded alone
__device__ __forceinline__ float scale_out(int acc, float s, float ws, const float* add) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s), ws);
  return add == nullptr ? v : __fadd_rn(v, *add);
}

__device__ __forceinline__ void put2(uint8_t* p, float a, float b, float) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(uint8_t* p, float a, float b, __nv_bfloat16) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One BM x BN tile of y = the scaled int8 product over all of K.
template <typename T, int WGS, int BN>
__global__ void __launch_bounds__(Tile<WGS, BN>::THREADS, Tile<WGS, BN>::BLOCKS)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap, const float* __restrict__ xs,
                  const float* __restrict__ w_scale, const float* __restrict__ addend, int m,
                  int N, int slices) {
  using TL = Tile<WGS, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_ring = align1024(smem_raw);               // STAGES x8 slices (BM x 128 bytes)
  uint8_t* b_ring = a_ring + STAGES * TL::A_BYTES;     // STAGES w_nk slices (BN x 128 bytes)
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + STAGES * TL::B_BYTES);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TL::CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= TL::CONSUMERS / 32) {   // the producer warpgroup: one lane issues the copies
    regs_release<PRODUCER_REGS>();
    if (warp == TL::CONSUMERS / 32 && lane == 0) {
      // the weight does not depend on the quantize pass: its first slices
      // load while that pass may still run; x8 only after it has finished
      const int first = slices < STAGES ? slices : STAGES;
      for (int i = 0; i < first; ++i) {
        mbar_arrive_expect_tx(&full[i], TL::A_BYTES + TL::B_BYTES);
        tma_load_2d(b_ring + i * TL::B_BYTES, &wmap, &full[i], i * BK, n0);
      }
      griddep_wait();
      for (int i = 0; i < slices; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) {
          mbar_wait(&empty[s], (i / STAGES - 1) & 1);
          mbar_arrive_expect_tx(&full[s], TL::A_BYTES + TL::B_BYTES);
          tma_load_2d(b_ring + s * TL::B_BYTES, &wmap, &full[s], i * BK, n0);
        }
        tma_load_2d(a_ring + s * TL::A_BYTES, &xmap, &full[s], i * BK, m0);
      }
    }
    return;
  }
  regs_claim<TL::REGS>();

  const int c = threadIdx.x >> 7;                      // this thread's warpgroup: rows 64 c ..
  const int r0 = m0 + 64 * c;
  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  for (int i = 0; i < slices; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    fence_regs(d);
    wgmma_fence();
    const uint8_t* a = a_ring + s * TL::A_BYTES + c * 64 * BK;
    const uint8_t* b = b_ring + s * TL::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      mma_slice(d, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();   // slice i - 1's products are done: free its stage
    fence_regs(d);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);
  griddep_wait();                       // xs was written by the quantize pass
  // every warpgroup is done reading the ring: it stages the output, as
  // BN / (128 / sizeof(T)) swizzled boxes of 64 rows x 128 bytes a warpgroup
  named_barrier(1, TL::CONSUMERS);
  uint8_t* stage = a_ring + c * (BN * 64 * sizeof(T));
  constexpr int BOX = 128 / sizeof(T);   // columns a box
  const int t = threadIdx.x & 127, w = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 16 * w + g + 8 * h, row = r0 + rl;
    const float sx = row < m ? xs[row] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * q, col = n0 + cl;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = row < m && col + e < N;   // else clipped by the store
        v[e] = scale_out(d[4 * j + 2 * h + e], sx, in ? w_scale[col + e] : 0.f,
                         addend != nullptr && in ? addend + (long long)row * N + col + e
                                                 : nullptr);
      }
      put2(stage + (cl / BOX) * 8192 + sw128(rl, (cl % BOX) * sizeof(T)), v[0], v[1], T());
    }
  }
  fence_proxy_async();
  named_barrier(2 + c, 128);
  if (t == 0) {
#pragma unroll
    for (int b = 0; b < BN / BOX; ++b) tma_store_2d(&ymap, stage + b * 8192, n0 + b * BOX, r0);
    bulk_commit();
    bulk_wait();
  }
}

template <typename T, int WGS, int BN>
cudaError_t gemm(const int8_t* x8, const int8_t* w_nk, const float* xs, const float* w_scale,
                 const float* addend, void* y, int m, int K, int N, cudaStream_t st) {
  using TL = Tile<WGS, BN>;
  CUtensorMap xmap, wmap, ymap;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)m}, wdims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t ydims[2] = {(uint64_t)N, (uint64_t)m};
  const uint64_t stride[1] = {(uint64_t)K}, ystride[1] = {(uint64_t)N * sizeof(T)};
  const uint32_t xbox[2] = {BK, TL::BM}, wbox[2] = {BK, BN};
  const uint32_t ybox[2] = {128 / sizeof(T), 64};
  const CUtensorMapDataType yt =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e;
  if ((e = encode_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, xdims, stride,
                             xbox)) != cudaSuccess ||
      (e = encode_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w_nk, wdims, stride,
                             wbox)) != cudaSuccess ||
      (e = encode_tensor_map(&ymap, yt, 2, y, ydims, ystride, ybox)) != cudaSuccess)
    return e;
  static bool done[64] = {};
  if ((e = allow_dynamic_smem(w8a8_wgmma_kernel<T, WGS, BN>, TL::SMEM, done)) != cudaSuccess)
    return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (m + TL::BM - 1) / TL::BM, 1);
  cfg.blockDim = dim3(TL::THREADS, 1, 1);
  cfg.dynamicSmemBytes = TL::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8a8_wgmma_kernel<T, WGS, BN>, xmap, wmap, ymap, xs, w_scale,
                            addend, m, N, (K + BK - 1) / BK);
}

// wide: the 128 x 256 tile, else 64 x 128
template <typename T>
cudaError_t w8a8(const void* x, const int8_t* w_nk, const float* w_scale, const float* keep,
                 const float* addend, const float* row_amax, float* xs, int8_t* x8, void* y,
                 int m, int K, int N, int wide, cudaStream_t st) {
  if (m < 1 || K < 1 || N < 1 || K % 16 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t e =
      quantize_rows(static_cast<const T*>(x), keep, row_amax, xs, x8, m, K, st);
  if (e != cudaSuccess) return e;
  return wide ? gemm<T, 2, 256>(x8, w_nk, xs, w_scale, addend, y, m, K, N, st)
              : gemm<T, 1, 128>(x8, w_nk, xs, w_scale, addend, y, m, K, N, st);
}

}  // namespace

// C entry. dtype: 0 = float32, 1 = bfloat16 (x and y). w_nk (N, K) int8
// row-major (the K-major copy of w_q8), w_scale (N,) fp32, keep (K,) fp32 or
// null, addend (m, N) fp32 or null, row_amax (m,) fp32 or null; x, y, addend
// contiguous, 16-byte aligned, K % 16 == 0, N % 8 == 0 (TMA's rule for a row
// pitch and a base). Scratch: xs (m,) fp32, x8 (m, K) int8.
// wide: the 128 x 256 tile, else 64 x 128.
extern "C" int w8a8_fwd(int dtype, const void* x, const int8_t* w_nk, const float* w_scale,
                        const float* keep, const float* addend, const float* row_amax,
                        float* xs, int8_t* x8, void* y, int m, int K, int N, int wide,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? w8a8<float>(x, w_nk, w_scale, keep, addend, row_amax, xs, x8, y, m, K, N,
                               wide, st)
                 : w8a8<__nv_bfloat16>(x, w_nk, w_scale, keep, addend, row_amax, xs, x8, y,
                                       m, K, N, wide, st));
}
