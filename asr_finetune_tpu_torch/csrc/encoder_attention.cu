// Encoder self-attention forward, written by hand for Hopper (sm_90a).
//
// Replaces asr_finetune_tpu/ops/encoder_attention.py `_fwd_packed` (:286),
// whose pl.pallas_call (:294) runs `_fwd_kernel_packed` (:206); reached
// through `encoder_attention` (:356). Per batch b and head h of packed
// (B, T, H*64) q/k/v it computes
//   s = (q_h . k_h) * 64^-0.5 in fp32, keys at col >= s_valid masked,
//   p = softmax(s) in fp32, out_h = p @ v_h with p cast to the input dtype
//   for that product (the TPU kernel's precision contract) and the division
//   by the row sum deferred past it.
//
// Bound on the card: operations. At whisper-large-v3 (B=4, H=20, T=1500) one
// layer is 46 GFLOP against 61 MB of q/k/v/out, ~750 flop per byte, well
// above the H100's ~295 in bf16.
//
// Design: the TPU kernel holds a whole 1500x1500 fp32 row tile in VMEM
// (~9 MB); an SM has 227 KB of shared memory. So this is an online-softmax
// (flash-style) loop: one block per (64-query tile, head, batch) reads its
// rows by strides straight from the packed layout, loops over 64-key tiles
// staged in shared memory, keeps the running row max m and sum l, and
// divides once at the end. The ragged edge (T = 1500 is no tile multiple)
// and s_valid are masked in the kernel. The epilogue holds m and l of every
// row, the (B, H, T) logsumexp a backward pass would keep as its residual.
//
// bf16 (the serving dtype) runs on the tensor cores: mma.sync m16n8k16 with
// fp32 accumulation, one warp per 16 query rows, the scores' accumulator
// fragments reused as the p@v A operand (p rounded to bf16 there, the TPU
// kernel's cast). fp32 inputs run a CUDA-core kernel with fp32 products.
// wgmma, TMA and a pipelined K/V ring are later work.
#include "common.cuh"

using namespace asr;

namespace {

constexpr int HD = 64;       // head dim of every released Whisper
constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256; // 16 x 16: thread (ty, tx) owns rows ty+16i, cols tx+16j
constexpr int LDS = HD + 1;  // padded row: column reads across tx hit distinct banks
constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * LDS + BK * LDS + BK * HD + BQ * LDS);

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

__global__ void __launch_bounds__(THREADS)
enc_attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
                 Strides sv, Strides so, int Tq, int n_kv, float scale) {
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * LDS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LDS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

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
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows = BQ
constexpr int LDB = HD + 8;       // bf16 row stride: fragment loads hit 32 banks

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
__global__ void __launch_bounds__(MMA_THREADS)
enc_attn_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 Strides sq, Strides sk, Strides sv, Strides so, int Tq, int n_kv,
                 float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ][LDB];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][LDB];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD][LDB];  // V transposed: [dim][key]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  q += b * sq.b + h * HD;
  k += b * sk.b + h * HD;
  v += b * sv.b + h * HD;
  o += b * so.b + h * HD;

  for (int c = tid; c < BQ * HD / 8; c += MMA_THREADS) {  // 16-byte chunks
    const int r = c >> 3, d0 = (c & 7) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Tq) u = *reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * sq.t + d0);
    *reinterpret_cast<uint4*>(&Qs[r][d0]) = u;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  uint32_t qa[4][4];             // Q as A fragments, 4 steps of 16 dims
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = ld32(&Qs[r0][ks * 16 + 2 * t]);
    qa[ks][1] = ld32(&Qs[r0 + 8][ks * 16 + 2 * t]);
    qa[ks][2] = ld32(&Qs[r0][ks * 16 + 8 + 2 * t]);
    qa[ks][3] = ld32(&Qs[r0 + 8][ks * 16 + 8 + 2 * t]);
  }

  float oacc[8][4];  // O: 8 tiles of 8 dims
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();  // the previous tile's fragments are read
    for (int c = tid; c < BK * HD / 8; c += MMA_THREADS) {
      {  // K row-major, coalesced: 8 lanes per key row
        const int r = c >> 3, d0 = (c & 7) * 8;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < n_kv) u = *reinterpret_cast<const uint4*>(k + (long long)(k0 + r) * sk.t + d0);
        *reinterpret_cast<uint4*>(&Ks[r][d0]) = u;
      }
      {  // V transposed; a warp takes 32 keys of one 8-dim chunk, so the
         // 2-byte stores of a warp land in distinct banks
        const int r = c & (BK - 1), d0 = (c / BK) * 8;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < n_kv) u = *reinterpret_cast<const uint4*>(v + (long long)(k0 + r) * sv.t + d0);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[d0 + j][r] = e[j];
      }
    }
    __syncthreads();

    float s[8][4];  // S = Q K^T: 8 tiles of 8 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(&Ks[nt * 8 + g][ks * 16 + 2 * t]),
                 ld32(&Ks[nt * 8 + g][ks * 16 + 8 + 2 * t]));
    }

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
    uint32_t pa[4][4];  // P as A fragments: the S tiles 2ks, 2ks+1 form step ks
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + (j & 1) < n_kv;
        p[j] = valid ? expf(s[nt][j] - m[j >> 1]) : 0.f;
        rs[j >> 1] += p[j];  // the row sum takes p in fp32 ...
      }
      // ... the p@v product takes it in bf16
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
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
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        mma_bf16(oacc[dt], pa[ks], ld32(&Vt[dt * 8 + g][ks * 16 + 2 * t]),
                 ld32(&Vt[dt * 8 + g][ks * 16 + 8 + 2 * t]));
    }
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
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Tq, int n_kv, Strides sq, Strides sk, Strides sv, Strides so,
                       cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        enc_attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  enc_attn_fwd_f32<<<dim3((Tq + BQ - 1) / BQ, H, B), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, sv, so, Tq, n_kv, 0.125f /* 64^-0.5 */);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the innermost
// (head-dim) stride is 1, time and batch strides multiples of 8.
extern "C" int encoder_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                     void* o, int B, int H, int Tq, int Tk, int s_valid,
                                     long long q_bs, long long q_ts, long long k_bs,
                                     long long k_ts, long long v_bs, long long v_ts,
                                     long long o_bs, long long o_ts, void* stream) {
  const int n_kv = s_valid < Tk ? s_valid : Tk;
  const Strides sq{q_bs, q_ts}, sk{k_bs, k_ts}, sv{v_bs, v_ts}, so{o_bs, o_ts};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_f32(q, k, v, o, B, H, Tq, n_kv, sq, sk, sv, so, st));
  enc_attn_fwd_mma<<<dim3((Tq + BQ - 1) / BQ, H, B), MMA_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, sv, so, Tq,
      n_kv, 0.125f /* 64^-0.5 */);
  return static_cast<int>(cudaGetLastError());
}
