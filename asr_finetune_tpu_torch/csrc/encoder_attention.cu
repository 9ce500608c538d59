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
// 115 GFLOP against 108 MB (0.1165 ms at 989 TF/s). The teacher-forced
// cross-attention (Tq = a label bucket <= 448, Tk = 1500) is bytes-bound.
//
// Forward design: the TPU kernels hold a whole 1500x1500 fp32 row tile in
// VMEM (~9 MB); an SM has 227 KB of shared memory. So the forward is an
// online-softmax (flash-style) loop: one block per (64-query tile, head,
// batch) reads its rows by strides straight from the packed layout, loops
// over 64-key tiles staged in shared memory, keeps the running row max m and
// sum l, and divides once at the end. The ragged edge (T = 1500 is no tile
// multiple) and s_valid are masked in the kernel. bf16 runs mma.sync
// m16n8k16 with fp32 accumulation, one warp per 16 rows, the score
// accumulators reused in registers as the next product's A operand (p
// rounded to bf16 there, the TPU kernel's cast); fp32 inputs run CUDA-core
// kernels with fp32 products.
//
// Backward, bf16: three launches on wgmma and TMA (hopper.cuh), seven tile
// products where the first design ran nine on mma.sync with synchronous
// staging and element-by-element transposed copies:
//   1. di pass, query-major: one block per 128 queries of one (b, h), two
//      consumer warpgroups of 64 rows; a producer warp loads Q and dO once
//      and streams 64-key tiles of K and V through a 3-stage mbarrier ring.
//      s = q.k^T and dp = do.v^T on wgmma (2 products) give di; the block
//      also zeroes its rows of the fp32 dq accumulator.
//   2. key-major pass: one block per 128 keys of one (b, h), two consumer
//      warpgroups and a producer warpgroup (setmaxnreg); K and V land once,
//      the producer streams 64-query tiles of Q and dO with their lse and di
//      slices through a 3-stage ring. S^T = K.Q^T and dP^T = V.dO^T (both
//      operands K-major); P^T, dS^T in registers; dV += P^T.dO and
//      dK += dS^T.Q with A from registers and B the same Q / dO tile read
//      MN-major through the descriptor's transpose bit (one copy of every
//      tile in shared memory, no transposed staging); dS^T stored once,
//      swizzled, and dQ = dS.K (each warpgroup 32 of the 64 dims) added to a
//      (B, H, Tq, 64) fp32 accumulator by TMA reduce-add (5 products). The
//      next tile's S^T and dP^T are issued behind the dQ product.
//   3. dq = scale * accumulator, rounded to bf16 into dq's strided layout.
// A 64-dim bf16 row is 128 bytes, the swizzle atom: every TMA box (64 rows x
// 64 dims of one head, a 4-D map over (dim, head, time, batch) with the
// operand's strides) lands in wgmma's canonical layout, rows past T zero.
// The reduce-adds make dq's fp32 summation order vary from run to run, far
// below one bf16 step; dk and dv are deterministic. At large-v3 (B 4, T
// 1500) the backward reads 0.51 ms on an H100 (chip_smoke.py), SDPA's 0.36:
// the same ~316 TFLOP/s a product, SDPA on five, which take di from
// rowsum(dO * O) where this contract recomputes it (two products).
// The fp32 route stays deterministic: two CUDA-core kernels (dq with di,
// then dk/dv) that recompute p tile by tile, nine products, no atomics.
#include "common.cuh"
#include "hopper.cuh"

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

struct Strides {
  long long b, t;  // element strides of batch and time in a packed (B, T, H*64) tensor
};

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

// ---------------------------------------------------------------------------
// bf16 backward on wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int WG = 128;                       // one warpgroup
constexpr int DI_WGS = 2;                     // di pass: consumer warpgroups (64 queries each)
constexpr int DI_THREADS = DI_WGS * WG + 32;  // + a producer warp (under 100 registers: no setmaxnreg)
constexpr int KV_THREADS = 3 * WG;            // key-major pass: two consumer warpgroups + a producer one
constexpr int TILE = 64 * HD * 2;             // one 64-row bf16 tile: 8 KB, 64 rows of 128 bytes
constexpr int STAGES = 3;                     // the producer's ring
constexpr float LOG2E = 1.4426950408889634f;
// di pass: Q and dO of 128 queries, a ring of K and V tiles, the barriers
constexpr int DI_SMEM = 2 * DI_WGS * TILE + STAGES * 2 * TILE + 8 * (1 + 2 * STAGES) + 1024;
// key-major pass: K and V of 128 keys, a ring of Q and dO tiles with their
// lse and di, two dS^T buffers of 128 keys x 64 queries, two fp32 dQ
// halves per warpgroup (64 queries x 32 dims), the barriers
constexpr int KV_SMEM = 4 * TILE + STAGES * 2 * TILE + 2 * 2 * TILE + 4 * TILE +
                        STAGES * 2 * 64 * 4 + 8 * (1 + 2 * STAGES) + 1024;

// The (64 x 64) rows [t0, t0 + 64) of head h of batch b, by TMA into one
// swizzled tile; rows past T read as zero.
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int t0, int b) {
  tma_load_4d(dst, map, bar, 0, h, t0, b);
}

// a warp's lane 0 arrives on `bar` once every lane of the warp is done
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// S (64 x 64, fp32, +=/=) = A (64 x 64 rows of 128 bytes, K-major) . B^T
// (B 64 x 64, K-major): four k-steps of 16 dims
__device__ __forceinline__ void product_abt(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_bf16_n64<0, 0>(d, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk), kk > 0);
}


// S and dP of one tile pair (64 x 64 each), issued and committed as one
// wgmma group
__device__ __forceinline__ void issue_s_dp(float (&sc)[32], float (&dp)[32], const uint8_t* a0,
                                           const uint8_t* b0, const uint8_t* a1,
                                           const uint8_t* b1) {
  wgmma_fence();
  product_abt(sc, a0, b0);
  product_abt(dp, a1, b1);
  wgmma_commit();
}

// di += rowsum(p * dp) over one 64-key tile, p = exp(s - lse) masked at
// keys >= n_kv (s, dp in the accumulator layout; rows e >> 1)
__device__ __forceinline__ void di_tile(float (&di)[2], const float (&sc)[32],
                                        const float (&dp)[32], const float (&lrow)[2], int k0,
                                        int n_kv, int qd, float sl) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * qd + (e & 1);
      const float p = col < n_kv ? exp2_fast(sc[4 * j + e] * sl - lrow[e >> 1]) : 0.f;
      di[e >> 1] = fmaf(p, dp[4 * j + e], di[e >> 1]);
    }
}

// Pass 1, query-major: di = rowsum(p * dp) of 128 queries of one (b, h),
// p = exp(s - lse) and dp = do . v^T in fp32 from two wgmma products per
// key tile (the TPU kernel's di, from unrounded p and dp). Under 100
// registers a thread, two blocks (four consumer warpgroups) share an SM and
// overlap one's products with another's exponentials (a pipelined form with
// two register sets, one block an SM, was slower on an H100). It also
// zeroes the queries' rows of the fp32 dq accumulator the key-major pass
// adds to.
__global__ void __launch_bounds__(DI_THREADS, 2)
enc_attn_bwd_di_wgmma(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dmap, const float* __restrict__ lse,
                      float* __restrict__ di_out, float* __restrict__ dq_acc, int Tq, int n_kv,
                      float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);        // DI_WGS tiles: queries q0 .. q0 + 64 DI_WGS - 1
  uint8_t* Ds = Qs + DI_WGS * TILE;         // dO, the same rows
  uint8_t* Kr = Ds + DI_WGS * TILE;         // STAGES key tiles
  uint8_t* Vr = Kr + STAGES * TILE;         // STAGES value tiles
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(Vr + STAGES * TILE);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * 64 * DI_WGS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_kt = (n_kv + BK - 1) / BK;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DI_WGS * WG / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == DI_WGS * WG / 32) {   // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(qd_full, 2 * DI_WGS * TILE);
      for (int i = 0; i < DI_WGS; ++i) {
        load_rows(Qs + i * TILE, &qmap, qd_full, h, q0 + 64 * i, b);
        load_rows(Ds + i * TILE, &dmap, qd_full, h, q0 + 64 * i, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        load_rows(Kr + s * TILE, &kmap, &full[s], h, i * BK, b);
        load_rows(Vr + s * TILE, &vmap, &full[s], h, i * BK, b);
      }
    }
    return;
  }

  const int c = warp >> 2, t = threadIdx.x & (WG - 1);
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = q0 + 64 * c + 16 * (warp & 3) + g;   // this thread's rows r0, r0 + 8
  float lrow[2], di[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) lrow[e] = r0 + 8 * e < Tq ? lse[rows + r0 + 8 * e] * LOG2E : 0.f;
  // zero the warpgroup's 64 rows of dq_acc (B, H, Tq, 64)
  for (int i = t; i < 64 * HD / 4; i += WG) {
    const int r = q0 + 64 * c + i / (HD / 4);
    if (r < Tq)
      reinterpret_cast<float4*>(dq_acc + (rows + r) * HD)[i % (HD / 4)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float sl = scale * LOG2E;
  const uint8_t* Qc = Qs + c * TILE;
  const uint8_t* Dc = Ds + c * TILE;
  mbar_wait(qd_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    float sc[32], dp[32];
    issue_s_dp(sc, dp, Qc, Kr + s * TILE, Dc, Vr + s * TILE);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    warp_arrive(&empty[s]);
    di_tile(di, sc, dp, lrow, i * BK, n_kv, qd, sl);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    di[e] += __shfl_xor_sync(0xffffffffu, di[e], 1);
    di[e] += __shfl_xor_sync(0xffffffffu, di[e], 2);
    if (qd == 0 && r0 + 8 * e < Tq) di_out[rows + r0 + 8 * e] = di[e];
  }
}

// Pass 2, key-major: one block per 128 keys of one (b, h), two consumer
// warpgroups of 64 keys each and a producer warpgroup (setmaxnreg: 56
// registers for it, 224 for the consumers; at 384 threads ptxas caps a
// thread at 168, and the pipelined loop spilled under that). K and V land
// once by TMA; the producer streams 64-query tiles of Q and dO, with their
// lse and di slices, through a ring. Per query tile, a warpgroup runs
//   S^T = K . Q^T, dP^T = V . dO^T       (wgmma, both operands K-major)
//   P^T, dS^T in registers, masked        (keys >= n_kv, queries >= Tq: p = 0)
//   dV += P^T . dO, dK += dS^T . Q        (wgmma, A = P^T / dS^T from registers
//                                          as bf16, B = the same dO / Q tile
//                                          read MN-major)
// and writes dS^T (bf16) to shared memory once; then, with both warpgroups'
// rows there, warpgroup c runs dQ[:, 32c : 32c + 32] = dS . K (dS^T read
// MN-major as A, K MN-major as B), and the next tile's S^T and dP^T are
// issued behind it. The dQ half goes to shared memory, swizzled, and one
// thread adds it into the fp32 dq accumulator with a TMA reduce-add, off
// the warpgroup's path (per-thread atomic adds stalled it). Seven products a tile pair with the di pass. (Tried and
// slower on an H100: A operands from registers for S^T and dP^T, each
// warpgroup's own dQ over its 64 keys, and ping-pong turns of the two
// warpgroups at the tensor cores.)
__global__ void __launch_bounds__(KV_THREADS, 1)
enc_attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap accmap, const float* __restrict__ lse,
                        const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        Strides sdk, Strides sdv, int Tq, int Tk, int n_kv, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);        // 2 tiles: keys k0 .. k0 + 127
  uint8_t* Vs = Ks + 2 * TILE;
  uint8_t* Qr = Vs + 2 * TILE;              // STAGES query tiles
  uint8_t* Dr = Qr + STAGES * TILE;         // STAGES dO tiles
  uint8_t* dS = Dr + STAGES * TILE;         // 2 buffers of dS^T: 128 keys x 64 queries
  uint8_t* dQs = dS + 4 * TILE;             // 2 warpgroups x 2 buffers: 64 queries x 32 fp32
  float* lse_s = reinterpret_cast<float*>(dQs + 4 * TILE);   // STAGES x 64, times log2 e
  float* di_s = lse_s + STAGES * 64;                        // STAGES x 64
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(di_s + STAGES * 64);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * 128, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rows = ((long long)b * gridDim.y + h) * Tq;
  dk += b * sdk.b + h * HD;
  dv += b * sdv.b + h * HD;

  if (k0 >= n_kv) {   // every key masked: zero gradients, no dq
    for (int i = threadIdx.x; i < 128 * HD / 8; i += KV_THREADS) {
      const int r = k0 + i / (HD / 8), d0 = (i % (HD / 8)) * 8;
      if (r < Tk) {
        *reinterpret_cast<uint4*>(dk + (long long)r * sdk.t + d0) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + (long long)r * sdv.t + d0) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int n_qt = (Tq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * WG / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 2 * WG / 32) {   // the producer warpgroup: its first warp loads
    regs_release<PRODUCER_REGS>();
    if (warp != 2 * WG / 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 4 * TILE);
      for (int i = 0; i < 2; ++i) {
        load_rows(Ks + i * TILE, &kmap, kv_full, h, k0 + 64 * i, b);
        load_rows(Vs + i * TILE, &vmap, kv_full, h, k0 + 64 * i, b);
      }
    }
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = i * BQ + 2 * lane + e;
        lse_s[s * 64 + 2 * lane + e] = r < Tq ? lse[rows + r] * LOG2E : 0.f;
        di_s[s * 64 + 2 * lane + e] = r < Tq ? di[rows + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        load_rows(Qr + s * TILE, &qmap, &full[s], h, i * BQ, b);
        load_rows(Dr + s * TILE, &dmap, &full[s], h, i * BQ, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  regs_claim<CONSUMER_REGS>();
  const int c = warp >> 2, w = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int kr = 16 * w + g;                          // this thread's key rows kr, kr + 8 of the warpgroup
  const bool lead = (threadIdx.x & (WG - 1)) == 0;    // the warpgroup's TMA-reduce thread
  const bool key_ok[2] = {k0 + 64 * c + kr < n_kv, k0 + 64 * c + kr + 8 < n_kv};
  const float sl = scale * LOG2E;
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  const uint8_t* Kc = Ks + c * TILE;
  const uint8_t* Vc = Vs + c * TILE;
  mbar_wait(kv_full, 0);

  float st[32], dpt[32];
  mbar_wait(&full[0], 0);
  issue_s_dp(st, dpt, Kc, Qr, Vc, Dr);
  for (int i = 0; i < n_qt; ++i) {
    const int s = i % STAGES;
    const uint8_t* Qt = Qr + s * TILE;
    const uint8_t* Dt = Dr + s * TILE;
    uint8_t* dSb = dS + (i & 1) * 2 * TILE;   // dS^T of the block's 128 keys
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p^T and ds^T: rows are keys, columns queries
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * qd + (e & 1);
        const bool ok = key_ok[e >> 1] && i * BQ + col < Tq;
        p[e] = ok ? exp2_fast(st[4 * j + e] * sl - lse_s[s * 64 + col]) : 0.f;
        ds[e] = p[e] * (dpt[4 * j + e] - di_s[s * 64 + col]);
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      // dS^T rows kr, kr + 8 of this warpgroup into the swizzled buffer
      const int col_b = (8 * j + 2 * qd) * 2;
      *reinterpret_cast<uint32_t*>(dSb + sw128(64 * c + kr, col_b)) = dsa[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(dSb + sw128(64 * c + kr + 8, col_b)) =
          dsa[j >> 1][(j & 1) * 2 + 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(dsa[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // k-steps of 16 queries: 2048 bytes of an MN-major tile
      wgmma_rs_bf16_n64<1>(dva, pa[kk], sw128_desc(Dt + 2048 * kk), 1);
      wgmma_rs_bf16_n64<1>(dka, dsa[kk], sw128_desc(Qt + 2048 * kk), 1);
    }
    wgmma_commit();

    // dQ: both warpgroups' dS^T rows must be in shared memory; the reduce
    // of two tiles ago must be done reading this tile's dQ buffer
    if (lead) bulk_wait_read<1>();
    fence_proxy_async();
    named_barrier(1, 2 * WG);
    float dqa[16];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)     // k-steps of 16 keys over the block's 128
      wgmma_ss_bf16_n32<1, 1>(dqa, sw128_desc(dSb + 2048 * kk),
                              sw128_desc(Ks + 2048 * kk + 64 * c), kk > 0);
    wgmma_commit();
    if (i + 1 < n_qt) {   // the next tile's S^T and dP^T run behind dQ
      const int s1 = (i + 1) % STAGES;
      mbar_wait(&full[s1], ((i + 1) / STAGES) & 1);
      issue_s_dp(st, dpt, Kc, Qr + s1 * TILE, Vc, Dr + s1 * TILE);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(dqa);
    warp_arrive(&empty[s]);

    // rows 16 w + g (+ 8) of the query tile, cols 8 j + 2 qd of this
    // warpgroup's 32: a swizzled 64 x 128-byte box, added by TMA
    uint8_t* dqb = dQs + (2 * c + (i & 1)) * TILE;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(dqb + sw128(16 * w + g + 8 * e, (8 * j + 2 * qd) * 4)) =
            make_float2(dqa[4 * j + 2 * e], dqa[4 * j + 2 * e + 1]);
    fence_proxy_async();
    named_barrier(2 + c, WG);
    if (lead) {
      tma_reduce_add_3d(&accmap, dqb, 32 * c, i * BQ, b * gridDim.y + h);
      bulk_commit();
    }
  }
  if (lead) bulk_wait();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = k0 + 64 * c + kr + 8 * e;
    if (r >= Tk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d0 = 8 * j + 2 * qd;
      *reinterpret_cast<uint32_t*>(dk + (long long)r * sdk.t + d0) =
          pack_bf16(dka[4 * j + 2 * e] * scale, dka[4 * j + 2 * e + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + (long long)r * sdv.t + d0) =
          pack_bf16(dva[4 * j + 2 * e], dva[4 * j + 2 * e + 1]);
    }
  }
}

// Pass 3: dq = scale * dq_acc, rounded to bf16 into dq's strided layout;
// a thread takes 8 dims of one row of batch blockIdx.y.
__global__ void __launch_bounds__(256)
enc_attn_bwd_dq_store(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                      Strides sdq, int H, int Tq, float scale) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)H * Tq * (HD / 8)) return;
  const int b = blockIdx.y, d0 = (i % (HD / 8)) * 8;
  const long long row = i / (HD / 8);            // h * Tq + t
  const int h = row / Tq, t = row % Tq;
  const float4* src =
      reinterpret_cast<const float4*>(dq_acc + ((long long)b * H * Tq + row) * HD + d0);
  const float4 a = src[0], c = src[1];
  const uint4 out = make_uint4(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
                               pack_bf16(c.x * scale, c.y * scale), pack_bf16(c.z * scale, c.w * scale));
  *reinterpret_cast<uint4*>(dq + b * sdq.b + (long long)t * sdq.t + h * HD + d0) = out;
}

// the tensor map of a (B, T, H*64) bf16 operand with element strides (bs,
// ts): dims (64, H, T, B), 64 x 64 boxes of one (b, h)
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int H, int T, Strides st) {
  const uint64_t dims[4] = {HD, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[3] = {HD * 2, (uint64_t)st.t * 2, (uint64_t)st.b * 2};
  const uint32_t box[4] = {HD, 1, 64, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
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
    static bool done[64] = {};
    const cudaError_t e = allow_dynamic_smem(enc_attn_fwd_f32, SMEM_BYTES, done);
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
// and the second reads; in bf16, dq_acc is (B, H, Tq, 64) fp32 scratch the
// first kernel zeroes, the second adds to and the third scales into dq. All
// run on `stream`, in order. bf16 needs every stride (bytes) and base
// 16-byte aligned (TMA): cudaErrorInvalidValue otherwise.
extern "C" int encoder_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, void* di, void* dq_acc,
                                     void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk,
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
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  const float scale = 0.125f;  // 64^-0.5
  cudaError_t e;
  if (dtype == 0) {
    using F = float;
    const dim3 grid_q((Tq + BQ - 1) / BQ, H, B), grid_k((Tk + BK - 1) / BK, H, B);
    static bool done_q[64] = {}, done_k[64] = {};
    if ((e = allow_dynamic_smem(enc_attn_bwd_dq_f32, BWD_DQ_SMEM, done_q)) != cudaSuccess) return e;
    if ((e = allow_dynamic_smem(enc_attn_bwd_dkdv_f32, BWD_DKDV_SMEM, done_k)) != cudaSuccess)
      return e;
    enc_attn_bwd_dq_f32<<<grid_q, THREADS, BWD_DQ_SMEM, st>>>(
        static_cast<const F*>(q), static_cast<const F*>(k), static_cast<const F*>(v),
        static_cast<const F*>(dout), l, d, static_cast<F*>(dq), sq, sk, sv, sdo, sdq, Tq, n_kv,
        scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    enc_attn_bwd_dkdv_f32<<<grid_k, THREADS, BWD_DKDV_SMEM, st>>>(
        static_cast<const F*>(q), static_cast<const F*>(k), static_cast<const F*>(v),
        static_cast<const F*>(dout), l, d, static_cast<F*>(dk), static_cast<F*>(dv), sq, sk,
        sv, sdo, sdk, sdv, Tq, Tk, n_kv, scale);
    return static_cast<int>(cudaGetLastError());
  }
  using T = __nv_bfloat16;
  CUtensorMap qm, km, vm, dm;
  if ((e = head_map(&qm, q, B, H, Tq, sq)) != cudaSuccess ||
      (e = head_map(&km, k, B, H, Tk, sk)) != cudaSuccess ||
      (e = head_map(&vm, v, B, H, Tk, sv)) != cudaSuccess ||
      (e = head_map(&dm, dout, B, H, Tq, sdo)) != cudaSuccess)
    return e;
  static bool done_di[64] = {}, done_kv[64] = {};
  if ((e = allow_dynamic_smem(enc_attn_bwd_di_wgmma, DI_SMEM, done_di)) != cudaSuccess) return e;
  if ((e = allow_dynamic_smem(enc_attn_bwd_dkdv_wgmma, KV_SMEM, done_kv)) != cudaSuccess) return e;
  float* acc = static_cast<float*>(dq_acc);
  CUtensorMap am;   // dq_acc (B*H, Tq, 64) fp32: boxes of 64 rows x 32 dims
  {
    const uint64_t dims[3] = {HD, (uint64_t)Tq, (uint64_t)B * H};
    const uint64_t strides[2] = {HD * 4, (uint64_t)Tq * HD * 4};
    const uint32_t box[3] = {32, 64, 1};
    if ((e = encode_tensor_map(&am, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, acc, dims, strides,
                               box)) != cudaSuccess)
      return e;
  }
  enc_attn_bwd_di_wgmma<<<dim3((Tq + 64 * DI_WGS - 1) / (64 * DI_WGS), H, B), DI_THREADS,
                          DI_SMEM, st>>>(
      qm, km, vm, dm, l, d, acc, Tq, n_kv, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  enc_attn_bwd_dkdv_wgmma<<<dim3((Tk + 127) / 128, H, B), KV_THREADS, KV_SMEM, st>>>(
      qm, km, vm, dm, am, l, d, static_cast<T*>(dk), static_cast<T*>(dv), sdk, sdv, Tq, Tk,
      n_kv, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long per_batch = (long long)H * Tq * (HD / 8);
  enc_attn_bwd_dq_store<<<dim3((unsigned)((per_batch + 255) / 256), B), 256, 0, st>>>(
      acc, static_cast<T*>(dq), sdq, H, Tq, scale);
  return static_cast<int>(cudaGetLastError());
}
