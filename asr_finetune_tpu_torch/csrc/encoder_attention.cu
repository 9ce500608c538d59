// Encoder self/cross attention, forward and backward, written by hand for
// Hopper (sm_90a).
//
// Forward. Replaces asr_finetune_tpu/ops/encoder_attention.py `_fwd_packed`
// (:286), whose pl.pallas_call (:294) runs `_fwd_kernel_packed` (:206);
// reached through `encoder_attention` (:356). Per batch b and head h of packed
// (B, T, H*64) q/k/v it computes
//   s = (q_h . k_h) * 64^-0.5 in fp32, keys at col >= s_valid masked,
//   p = softmax(s) in fp32, out_h = p @ v_h with p cast to the input dtype
//   for that product (the TPU kernel's precision contract) and the division
//   by the row sum deferred past it.
// On request it also writes the (B, H, Tq) fp32 logsumexp m + log(l) of every
// row, the residual the backward recomputes p from.
//
// Backward. Replaces `_bwd_packed` (:311), whose pl.pallas_call (:320) runs
// `_bwd_kernel_packed` (:225): from (q, k, v, do) and the forward's
// logsumexp, in fp32,
//   p = exp(s - lse), dp = do . v^T, di = rowsum(p * dp),
//   ds = p * (dp - di) rounded to the input dtype,
//   dq = scale ds . k, dk = scale ds^T . q, dv = p^T . do (p rounded to the
//   input dtype for that product), outputs in the input dtype.
// di takes the TPU kernel's form, from unrounded fp32 p and dp, not the
// flash-attention shortcut rowsum(do * o) over the rounded output.
//
// Bound on the card: operations. At whisper-large-v3 (B=4, H=20, T=1500) one
// layer's forward is 46 GFLOP against 61 MB of q/k/v/out, ~750 flop per byte,
// well above the H100's ~295 in bf16; the backward's five products are
// 115 GFLOP against 108 MB. The teacher-forced cross-attention (Tq = a label
// bucket <= 448, Tk = 1500) is bytes-bound.
//
// Design: the TPU kernels hold a whole 1500x1500 fp32 row tile in VMEM
// (~9 MB); an SM has 227 KB of shared memory. So the forward is an
// online-softmax (flash-style) loop: one block per (64-query tile, head,
// batch) reads its rows by strides straight from the packed layout, loops
// over 64-key tiles staged in shared memory, keeps the running row max m and
// sum l, and divides once at the end. The ragged edge (T = 1500 is no tile
// multiple) and s_valid are masked in the kernel.
//
// The backward is two deterministic kernels (no atomics), both recomputing p
// tile by tile from the saved logsumexp:
//   1. dq: one block per (64-query tile, head, batch). A first pass over the
//      key tiles sums di = rowsum(p * dp) and stores it (B, H, Tq) fp32; a
//      second pass recomputes p and dp, forms ds and accumulates ds . k.
//   2. dk/dv: one block per (64-key tile, head, batch) loops over the query
//      tiles, computes s^T and dp^T with the keys as rows, reads lse and di
//      per query column, and accumulates p^T . do and ds^T . q.
// That is nine tile products where the TPU kernel does five (the di pass and
// the dk/dv kernel's s/dp recompute): right first, fast later.
//
// bf16 (the training and serving dtype) runs on the tensor cores:
// mma.sync m16n8k16 with fp32 accumulation, one warp per 16 rows; score
// accumulators are reused in registers as the A operand of the next product
// (p and ds rounded to bf16 there, the TPU kernel's casts). fp32 inputs run
// CUDA-core kernels with fp32 products. wgmma, TMA and a pipelined K/V ring
// are later work.
#include "common.cuh"

using namespace asr;

namespace {

constexpr int HD = 64;       // head dim of every released Whisper
constexpr int BQ = 64;       // queries per tile
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256; // 16 x 16: thread (ty, tx) owns rows ty+16i, cols tx+16j
constexpr int LDS = HD + 1;  // padded row: column reads across tx hit distinct banks
constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * LDS + BK * LDS + BK * HD + BQ * LDS);
constexpr size_t BWD_DQ_SMEM = sizeof(float) * 5 * BQ * LDS;
constexpr size_t BWD_DKDV_SMEM = sizeof(float) * (6 * BQ * LDS + 2 * BQ);
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long b, t;  // element strides of batch and time in a packed (B, T, H*64) tensor
};

// Raise a kernel's dynamic shared-memory cap above the 48 KB default, once
// per device (the attribute is per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// rows [row0, row0 + 64) x 64 dims of `src` (already offset to batch and
// head) into `dst`; rows at or past n_avail read as zero
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, Strides st,
                                          int row0, int n_avail) {
  const int r = threadIdx.x >> 2, seg = (threadIdx.x & 3) * 16;
  float w0[8], w1[8];
  if (row0 + r < n_avail) {
    const float* p = src + (long long)(row0 + r) * st.t + seg;
    load8(p, w0);
    load8(p + 8, w1);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) w0[c] = w1[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    dst[r * ld + seg + c] = w0[c];
    dst[r * ld + seg + 8 + c] = w1[c];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d] over two row-major 64 x 64 tiles
__device__ __forceinline__ void tile_abt(float (&c)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LDS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * LDS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// c[i][j] += sum_r A[ty+16i][r] * B[r][tx+16j] over 64 x 64 tiles
__device__ __forceinline__ void tile_ab_acc(float (&c)[4][4], const float* A, const float* Bm,
                                            int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < 64; ++r) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LDS + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[r * LDS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS)
enc_attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 Strides sq, Strides sk, Strides sv, Strides so, int Tq, int n_kv,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDS;
  float* Vs = Ks + BK * LDS;
  float* Ps = Vs + BK * HD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  o += b * so.b + h * HD;

  load_tile(Qs, LDS, q, sq, q0, Tq);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();  // the previous tile's P@V is done with Ks/Vs/Ps
    load_tile(Ks, LDS, k, sk, k0, n_kv);
    load_tile(Vs, HD, v, sv, k0, n_kv);
    __syncthreads();

    float s[4][4];
    tile_abt(s, Qs, Ks, ty, tx);

    // online softmax: a row's 64 columns live on the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < n_kv) ? s[i][j] * scale : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx + 16 * j < n_kv) ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Tq) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[(long long)r * so.t + tx + 16 * j] = acc[i][j] * inv;
      if (lse != nullptr && tx == 0)
        lse[((long long)b * gridDim.y + h) * Tq + r] = m[i] + logf(l[i]);
    }
  }
}

// dq (and di) in fp32: block per (64-query tile, head, batch), thread (ty, tx)
// owns query rows ty+16i and key / dim columns tx+16j.
__global__ void __launch_bounds__(THREADS)
enc_attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ di_out,
                    float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, int Tq, int n_kv, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ds = Qs + BQ * LDS;
  float* Ks = Ds + BQ * LDS;
  float* Vs = Ks + BK * LDS;
  float* Ss = Vs + BK * LDS;  // ds tile [query][key]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  dout += b * sdo.b + h * HD;
  dq += b * sdq.b + h * HD;

  load_tile(Qs, LDS, q, sq, q0, Tq);
  load_tile(Ds, LDS, dout, sdo, q0, Tq);
  float lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lrow[i] = r < Tq ? lse[rows + r] : 0.f;
  }

  // pass 1: di = rowsum(p * dp) over every valid key
  float di[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();
    load_tile(Ks, LDS, k, sk, k0, n_kv);
    load_tile(Vs, LDS, v, sv, k0, n_kv);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt(s, Qs, Ks, ty, tx);
    tile_abt(dp, Ds, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx + 16 * j < n_kv) ? expf(s[i][j] * scale - lrow[i]) : 0.f;
        di[i] = fmaf(p, dp[i][j], di[i]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    di[i] = half_warp_sum(di[i]);
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < Tq) di_out[rows + r] = di[i];
  }

  // pass 2: ds = p * (dp - di); dq = scale * ds . k
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();
    load_tile(Ks, LDS, k, sk, k0, n_kv);
    load_tile(Vs, LDS, v, sv, k0, n_kv);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt(s, Qs, Ks, ty, tx);
    tile_abt(dp, Ds, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx + 16 * j < n_kv) ? expf(s[i][j] * scale - lrow[i]) : 0.f;
        Ss[(ty + 16 * i) * LDS + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    __syncthreads();
    tile_ab_acc(acc, Ss, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Tq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[(long long)r * sdq.t + tx + 16 * j] = acc[i][j] * scale;
    }
  }
}

// dk and dv in fp32: block per (64-key tile, head, batch), thread (ty, tx)
// owns key rows ty+16i and query / dim columns tx+16j.
__global__ void __launch_bounds__(THREADS)
enc_attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdk, Strides sdv, int Tq, int Tk,
                      int n_kv, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LDS;
  float* Qs = Vs + BK * LDS;
  float* Ds = Qs + BQ * LDS;
  float* Ps = Ds + BQ * LDS;  // p^T tile [key][query]
  float* Ss = Ps + BK * LDS;  // ds^T tile [key][query]
  float* ls = Ss + BK * LDS;  // lse of the tile's queries
  float* dis = ls + BQ;       // di of the tile's queries

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  dout += b * sdo.b + h * HD;
  dk += b * sdk.b + h * HD;
  dv += b * sdv.b + h * HD;

  load_tile(Ks, LDS, k, sk, k0, n_kv);
  load_tile(Vs, LDS, v, sv, k0, n_kv);
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + ty + 16 * i < n_kv;

  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();
    load_tile(Qs, LDS, q, sq, q0, Tq);
    load_tile(Ds, LDS, dout, sdo, q0, Tq);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < Tq ? lse[rows + r] : 0.f;
      dis[threadIdx.x] = r < Tq ? di[rows + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt(s, Ks, Qs, ty, tx);   // s^T: keys x queries
    tile_abt(dp, Vs, Ds, ty, tx);  // dp^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = (key_ok[i] && q0 + c < Tq) ? expf(s[i][j] * scale - ls[c]) : 0.f;
        Ps[(ty + 16 * i) * LDS + c] = p;
        Ss[(ty + 16 * i) * LDS + c] = p * (dp[i][j] - dis[c]);
      }
    __syncthreads();
    tile_ab_acc(dva, Ps, Ds, ty, tx);
    tile_ab_acc(dka, Ss, Qs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r < Tk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk[(long long)r * sdk.t + tx + 16 * j] = dka[i][j] * scale;
        dv[(long long)r * sdv.t + tx + 16 * j] = dva[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr int LDB = HD + 8;       // bf16 row stride: fragment loads hit 32 banks

using Tile = __nv_bfloat16[64][LDB];
constexpr int STAGE_CHUNKS = 64 * HD / 8 / MMA_THREADS;  // 16-byte chunks a thread stages

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats → one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. A (16 x 16, row):
// a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..).
// B (16 x 8, col): b0 = (2t..2t+1, g), b1 = (2t+8.., g). C (16 x 8): c0,c1 =
// (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1).

// rows [row0, row0 + 64) x 64 dims of `src` into dst[row][dim] by 16-byte
// chunks; rows at or past n_avail read as zero. A thread starts all its
// loads (STAGE_CHUNKS of them) before its first store, so they are in
// flight together.
__device__ __forceinline__ void stage(Tile& dst, const __nv_bfloat16* src, long long ts,
                                      int row0, int n_avail) {
  uint4 u[STAGE_CHUNKS];
#pragma unroll
  for (int i = 0; i < STAGE_CHUNKS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS, r = c >> 3, d0 = (c & 7) * 8;
    u[i] = row0 + r < n_avail
               ? *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ts + d0)
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < STAGE_CHUNKS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS;
    *reinterpret_cast<uint4*>(&dst[c >> 3][(c & 7) * 8]) = u[i];
  }
}

// the same rows transposed, dst[dim][row]; a warp takes 32 rows of one 8-dim
// chunk, so the 2-byte stores of a warp land in distinct banks
__device__ __forceinline__ void stage_t(Tile& dst, const __nv_bfloat16* src, long long ts,
                                        int row0, int n_avail) {
  uint4 u[STAGE_CHUNKS];
#pragma unroll
  for (int i = 0; i < STAGE_CHUNKS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS, r = c & 63, d0 = (c >> 6) * 8;
    u[i] = row0 + r < n_avail
               ? *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ts + d0)
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < STAGE_CHUNKS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS, r = c & 63, d0 = (c >> 6) * 8;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[d0 + j][r] = e[j];
  }
}

// rows r0, r0 + 8 of a staged [row][k] tile as A fragments, 4 steps of 16
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const Tile& s, int r0, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = ld32(&s[r0][ks * 16 + 2 * t]);
    a[ks][1] = ld32(&s[r0 + 8][ks * 16 + 2 * t]);
    a[ks][2] = ld32(&s[r0][ks * 16 + 8 + 2 * t]);
    a[ks][3] = ld32(&s[r0 + 8][ks * 16 + 8 + 2 * t]);
  }
}

// c (16 x 64, 8 tiles of 8 columns) += A (16 x 64) . B^T, B staged [n][k]
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const Tile& bt, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma_bf16(c[nt], a[ks], ld32(&bt[nt * 8 + g][ks * 16 + 2 * t]),
               ld32(&bt[nt * 8 + g][ks * 16 + 8 + 2 * t]));
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// a 16 x 64 accumulator (8 C tiles) as the A operand of the next product,
// rounded to bf16: C tiles 2ks, 2ks+1 form k-step ks
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt >> 1][(nt & 1) * 2] = pack_bf16(c[nt][0], c[nt][1]);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// rows r0, r0 + 8 of a 16 x 64 accumulator times `mul`, stored as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ts, int row0, int r0,
                                           int n_rows, const float (&c)[8][4], float mul,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + r0 + 8 * i;
    if (r < n_rows) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + (long long)r * ts + dt * 8 + 2 * t) =
            pack_bf16(c[dt][2 * i] * mul, c[dt][2 * i + 1] * mul);
    }
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
enc_attn_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                 int Tq, int n_kv, float scale) {
  __shared__ __align__(16) Tile Qs;
  __shared__ __align__(16) Tile Ks;
  __shared__ __align__(16) Tile Vt;  // V transposed: [dim][key]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  o += b * so.b + h * HD;

  stage(Qs, q, sq.t, q0, Tq);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  uint32_t qa[4][4];             // Q as A fragments, 4 steps of 16 dims
  load_a(qa, Qs, r0, t);

  float oacc[8][4];  // O: 8 tiles of 8 dims
  zero(oacc);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();  // the previous tile's fragments are read
    stage(Ks, k, sk.t, k0, n_kv);
    stage_t(Vt, v, sv.t, k0, n_kv);
    __syncthreads();

    float s[8][4];  // S = Q K^T: 8 tiles of 8 keys
    zero(s);
    mma_abt(s, qa, Ks, g, t);

    // online softmax; a row's 64 scores live on the 4 lanes of a quad
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + (j & 1) < n_kv;
        s[nt][j] = valid ? s[nt][j] * scale : NEG;
        mt[j >> 1] = fmaxf(mt[j >> 1], s[nt][j]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + (j & 1) < n_kv;
        s[nt][j] = valid ? expf(s[nt][j] - m[j >> 1]) : 0.f;
        rs[j >> 1] += s[nt][j];  // the row sum takes p in fp32 ...
      }
    uint32_t pa[4][4];  // ... the p@v product takes it in bf16
    c_to_a(pa, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      oacc[dt][0] *= corr[0];
      oacc[dt][1] *= corr[0];
      oacc[dt][2] *= corr[1];
      oacc[dt][3] *= corr[1];
    }
    mma_abt(oacc, pa, Vt, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    if (r < Tq) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(o + (long long)r * so.t + dt * 8 + 2 * t) =
            pack_bf16(oacc[dt][2 * i] * inv, oacc[dt][2 * i + 1] * inv);
      if (lse != nullptr && t == 0)
        lse[((long long)b * gridDim.y + h) * Tq + r] = m[i] + logf(l[i]);
    }
  }
}

// dq (and di) in bf16: block per (64-query tile, head, batch), warp w owns
// query rows 16w + g and 16w + g + 8 of the tile.
__global__ void __launch_bounds__(MMA_THREADS)
enc_attn_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ di_out,
                    __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, int Tq, int n_kv, float scale) {
  __shared__ __align__(16) Tile Ks;  // [key][dim]
  __shared__ __align__(16) Tile Vs;  // [key][dim]
  __shared__ __align__(16) Tile Kt;  // [dim][key]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  dout += b * sdo.b + h * HD;
  dq += b * sdq.b + h * HD;

  const int r0 = warp * 16 + g;
  uint32_t qa[4][4], da[4][4];  // Q and dO as A fragments, staged through Ks, Vs
  stage(Ks, q, sq.t, q0, Tq);
  stage(Vs, dout, sdo.t, q0, Tq);
  __syncthreads();
  load_a(qa, Ks, r0, t);
  load_a(da, Vs, r0, t);
  float lrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + r0 + 8 * i;
    lrow[i] = r < Tq ? lse[rows + r] : 0.f;
  }

  // pass 1: di = rowsum(p * dp) over every valid key
  float di[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();
    stage(Ks, k, sk.t, k0, n_kv);
    stage(Vs, v, sv.t, k0, n_kv);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qa, Ks, g, t);
    mma_abt(dp, da, Vs, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + (j & 1) < n_kv;
        const float p = valid ? expf(s[nt][j] * scale - lrow[j >> 1]) : 0.f;
        di[j >> 1] = fmaf(p, dp[nt][j], di[j >> 1]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    di[i] += __shfl_xor_sync(0xffffffffu, di[i], 1);
    di[i] += __shfl_xor_sync(0xffffffffu, di[i], 2);
    const int r = q0 + r0 + 8 * i;
    if (t == 0 && r < Tq) di_out[rows + r] = di[i];
  }

  // pass 2: ds = p * (dp - di) in bf16; dq = scale * ds . k
  float acc[8][4];
  zero(acc);
  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();
    stage(Ks, k, sk.t, k0, n_kv);
    stage(Vs, v, sv.t, k0, n_kv);
    stage_t(Kt, k, sk.t, k0, n_kv);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qa, Ks, g, t);
    mma_abt(dp, da, Vs, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + (j & 1) < n_kv;
        const float p = valid ? expf(s[nt][j] * scale - lrow[j >> 1]) : 0.f;
        s[nt][j] = p * (dp[nt][j] - di[j >> 1]);
      }
    uint32_t dsa[4][4];
    c_to_a(dsa, s);
    mma_abt(acc, dsa, Kt, g, t);
  }
  store_rows(dq, sdq.t, q0, r0, Tq, acc, scale, t);
}

// dk and dv in bf16: block per (64-key tile, head, batch), warp w owns key
// rows 16w + g and 16w + g + 8 of the tile; scores are computed transposed
// (keys as rows) so p^T and ds^T are A operands in registers.
__global__ void __launch_bounds__(MMA_THREADS)
enc_attn_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                      Strides sdo, Strides sdk, Strides sdv, int Tq, int Tk, int n_kv,
                      float scale) {
  __shared__ __align__(16) Tile Qs;  // [query][dim]
  __shared__ __align__(16) Tile Qt;  // [dim][query]
  __shared__ __align__(16) Tile Ds;  // dO [query][dim]
  __shared__ __align__(16) Tile Dt;  // dO [dim][query]
  __shared__ float ls[BQ], dis[BQ];

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  dout += b * sdo.b + h * HD;
  dk += b * sdk.b + h * HD;
  dv += b * sdv.b + h * HD;

  const int r0 = warp * 16 + g;
  uint32_t ka[4][4], va[4][4];  // K and V rows as A fragments, staged through Qs, Ds
  stage(Qs, k, sk.t, k0, n_kv);
  stage(Ds, v, sv.t, k0, n_kv);
  __syncthreads();
  load_a(ka, Qs, r0, t);
  load_a(va, Ds, r0, t);
  const bool key_ok[2] = {k0 + r0 < n_kv, k0 + r0 + 8 < n_kv};

  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();
    stage(Qs, q, sq.t, q0, Tq);
    stage_t(Qt, q, sq.t, q0, Tq);
    stage(Ds, dout, sdo.t, q0, Tq);
    stage_t(Dt, dout, sdo.t, q0, Tq);
    if (tid < BQ) {
      const int r = q0 + tid;
      ls[tid] = r < Tq ? lse[rows + r] : 0.f;
      dis[tid] = r < Tq ? di[rows + r] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];  // s^T, dp^T: keys x queries
    zero(s);
    zero(dp);
    mma_abt(s, ka, Qs, g, t);
    mma_abt(dp, va, Ds, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nt * 8 + 2 * t + (j & 1);
        const float p =
            (key_ok[j >> 1] && q0 + c < Tq) ? expf(s[nt][j] * scale - ls[c]) : 0.f;
        s[nt][j] = p;
        dp[nt][j] = p * (dp[nt][j] - dis[c]);
      }
    uint32_t pa[4][4], dsa[4][4];
    c_to_a(pa, s);
    c_to_a(dsa, dp);
    mma_abt(dva, pa, Dt, g, t);
    mma_abt(dka, dsa, Qt, g, t);
  }
  store_rows(dk, sdk.t, k0, r0, Tk, dka, scale, t);
  store_rows(dv, sdv.t, k0, r0, Tk, dva, 1.f, t);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the innermost
// (head-dim) stride is 1, time and batch strides multiples of 8. lse, when
// not null, receives the (B, H, Tq) fp32 logsumexp of the rows.
extern "C" int encoder_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                     void* o, void* lse, int B, int H, int Tq, int Tk,
                                     int s_valid, long long q_bs, long long q_ts,
                                     long long k_bs, long long k_ts, long long v_bs,
                                     long long v_ts, long long o_bs, long long o_ts,
                                     void* stream) {
  const int n_kv = s_valid < Tk ? s_valid : Tk;
  const Strides sq{q_bs, q_ts}, sk{k_bs, k_ts}, sv{v_bs, v_ts}, so{o_bs, o_ts};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  float* l = static_cast<float*>(lse);
  const float scale = 0.125f;  // 64^-0.5
  if (dtype == 0) {
    static bool done[MAX_DEVICES] = {};
    const cudaError_t e = allow_smem(enc_attn_fwd_f32, SMEM_BYTES, done);
    if (e != cudaSuccess) return static_cast<int>(e);
    enc_attn_fwd_f32<<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), l, sq, sk, sv, so, Tq, n_kv,
        scale);
  } else {
    enc_attn_fwd_mma<<<grid, MMA_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), l, sq, sk, sv,
        so, Tq, n_kv, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of encoder_attention_fwd: dq, dk, dv from q, k, v, dout and
// the forward's lse. di is (B, H, Tq) fp32 scratch the first kernel fills
// and the second reads; both run on `stream`, in order.
extern "C" int encoder_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, void* di, void* dq,
                                     void* dk, void* dv, int B, int H, int Tq, int Tk,
                                     int s_valid, long long q_bs, long long q_ts,
                                     long long k_bs, long long k_ts, long long v_bs,
                                     long long v_ts, long long do_bs, long long do_ts,
                                     long long dq_bs, long long dq_ts, long long dk_bs,
                                     long long dk_ts, long long dv_bs, long long dv_ts,
                                     void* stream) {
  const int n_kv = s_valid < Tk ? s_valid : Tk;
  const Strides sq{q_bs, q_ts}, sk{k_bs, k_ts}, sv{v_bs, v_ts}, sdo{do_bs, do_ts},
      sdq{dq_bs, dq_ts}, sdk{dk_bs, dk_ts}, sdv{dv_bs, dv_ts};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_q((Tq + BQ - 1) / BQ, H, B), grid_k((Tk + BK - 1) / BK, H, B);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  const float scale = 0.125f;  // 64^-0.5
  cudaError_t e;
  if (dtype == 0) {
    using F = float;
    static bool done_q[MAX_DEVICES] = {}, done_k[MAX_DEVICES] = {};
    if ((e = allow_smem(enc_attn_bwd_dq_f32, BWD_DQ_SMEM, done_q)) != cudaSuccess) return e;
    if ((e = allow_smem(enc_attn_bwd_dkdv_f32, BWD_DKDV_SMEM, done_k)) != cudaSuccess) return e;
    enc_attn_bwd_dq_f32<<<grid_q, THREADS, BWD_DQ_SMEM, st>>>(
        static_cast<const F*>(q), static_cast<const F*>(k), static_cast<const F*>(v),
        static_cast<const F*>(dout), l, d, static_cast<F*>(dq), sq, sk, sv, sdo, sdq, Tq, n_kv,
        scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    enc_attn_bwd_dkdv_f32<<<grid_k, THREADS, BWD_DKDV_SMEM, st>>>(
        static_cast<const F*>(q), static_cast<const F*>(k), static_cast<const F*>(v),
        static_cast<const F*>(dout), l, d, static_cast<F*>(dk), static_cast<F*>(dv), sq, sk,
        sv, sdo, sdk, sdv, Tq, Tk, n_kv, scale);
  } else {
    using T = __nv_bfloat16;
    enc_attn_bwd_dq_mma<<<grid_q, MMA_THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), l, d, static_cast<T*>(dq), sq, sk, sv, sdo, sdq, Tq, n_kv,
        scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    enc_attn_bwd_dkdv_mma<<<grid_k, MMA_THREADS, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), l, d, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
        sv, sdo, sdk, sdv, Tq, Tk, n_kv, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
