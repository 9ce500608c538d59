// Fused per-token decoder kernels, written by hand for Hopper (sm_90a).
//
// Replaces three Pallas kernels of asr_finetune_tpu/ops/decoder_fused.py:
//   fused_qkv  (:150, pl.pallas_call :195, kernel _qkv_kernel :127)
//       LN(x) -> q = (h@wq + bq) * 64^-0.5 in fp32, k = h@wk, v = h@wv + bv
//   fused_attn (:310, pl.pallas_call :447, kernel _attn_kernel :213)
//       self mode: q given, keys at col > pos masked; cross mode: q =
//       (LN(x)@wq + bq) * 64^-0.5 computed here, keys at col >= s_valid
//       masked; softmax attention, then out = o@wo + bo + x
//   fused_mlp  (:681, pl.pallas_call :738, kernel _mlp_kernel :649)
//       out = gelu(LN(x)@w1 + b1) @ w2 + b2 + x, exact-erf GELU
// for any number of decode rows, reading layer l of the stacked (L, ...)
// weights and (L, B, T, d) caches through a pointer offset set by the
// wrapper: no slice is ever copied.
//
// int8 weights (the Pallas kernels' w*_scale option, :127-147, :310-447,
// :649-738): each projection of a launch may be int8 with an fp32
// per-output-channel scale while its neighbours are float (a merged-LoRA
// int8 base). The GEMV then streams 8 int8 bytes per lane per k instead of
// 16 (bf16) or 32 (fp32) bytes, widens them to float (exact: |w| <= 127),
// and the epilogue multiplies the fp32 sum by w_scale[n] before the bias,
// GELU, q scale or residual. blockIdx.y picks the projection, so the branch
// is uniform per block.
//
// Bound on the card: bytes. Each call streams its layer's weights (and, for
// attention, its K/V rows) once per group of up to 8 rows: at B=4 every
// weight element feeds 8 flops against 2 bytes (bf16), ~4 flop per byte
// against the ~295 the H100 needs before its tensor cores limit. So the
// design spends nothing on tensor cores and everything on streaming:
//
//  * gemv_kernel: out[b, n] = sum_k h[b, k] W[k, n] for all rows of a
//    group at once, so each weight byte is read once per group. A block
//    owns 16 output columns and splits K over 128 lanes (16-byte loads, 8
//    columns per thread), reduced by warp shuffles and one shared-memory
//    pass. Its prologue stages h in shared memory once (LN(x): x staged,
//    one warp per row for the statistics; or an input row as it is) and
//    its epilogue applies the bias, scale, GELU or residual of the
//    projection. One launch serves up to three projections (blockIdx.y),
//    so fused_qkv is one launch. Accumulators for 4 rows when B <= 4, else
//    8; more rows run as groups of 8, one launch each.
//  * attn_partial_kernel: split-T flash-decoding. The TPU kernel's grid of B
//    programs uses few of the 132 SMs; here one block per (row, head,
//    256-key chunk) scores its chunk (8 lanes per key row, 16-byte loads),
//    takes a chunk-local softmax and writes (m, l, p@v); only keys below
//    the valid bound are read. attn_combine_kernel merges the chunks of a
//    (row, head) into o, which the wo GEMV reads as its input.
//  * The TPU's head-expansion matrix M is a lane trick: here each block
//    reduces its own head directly.
//
// Numerics follow the Pallas kernels: LN statistics in fp32 and LN(x) cast to
// the activation dtype before the products; q arrives in fp32 and is cast to
// the K dtype before q.k; softmax state in fp32, p cast to the V dtype for
// p@v; o cast to x's dtype before @wo; products accumulate in fp32; bias and
// residual are added in fp32, then cast. GELU uses erff (the Pallas kernel
// needed an erf polynomial because Mosaic has none).
#include "common.cuh"

using namespace asr;

namespace {

constexpr int HD = 64;                   // head dim of every released Whisper
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CL = 2;                    // column lanes per k-lane
constexpr int VEC = 8;                   // columns per thread (one 16-byte load in bf16)
constexpr int NB = CL * VEC;             // columns per block
constexpr int KL = THREADS / CL;         // k-lanes
constexpr int MAX_ROWS = 8;              // decode rows per GEMV launch
constexpr int CHUNK = 256;               // keys per attention block
constexpr int ATT_THREADS = 128;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int KEY_LANES = 8;             // lanes per key row (8 x 8 dims)
constexpr int KEY_STEP = ATT_THREADS / KEY_LANES;  // keys per pass of a block

enum Prologue { PRO_LN = 0, PRO_INPUT = 1 };
enum Epilogue { EPI_Q = 0, EPI_PLAIN = 1, EPI_BIAS = 2, EPI_GELU = 3, EPI_RESID = 4 };

struct Proj {
  const void* w;         // (K, N) row-major, dtype T, or int8 when w8
  const void* bias;      // (N,) dtype T, or null for EPI_PLAIN
  void* out;             // (B, N): fp32 for EPI_Q, else T
  int epi;
  const float* w_scale;  // (N,) fp32 per-output-channel scale of an int8 w, else null
  int w8;                // the weight is int8
};

Proj proj(const void* w, const void* bias, void* out, int epi, const float* w_scale) {
  return Proj{w, bias, out, epi, w_scale, w_scale != nullptr};
}

struct GemvParams {
  int B, K, N, prologue;
  const void* x;                   // PRO_LN / PRO_INPUT: (B, K) in T
  const float* ln_s;               // PRO_LN: (K,) fp32
  const float* ln_b;
  const void* resid;               // EPI_RESID: (B, N) in T
  float q_scale;                   // EPI_Q
  Proj proj[3];
};

// n (a multiple of 8) elements of x into h_s as fp32, 16-byte loads: the
// staging is a chain of dependent loads per thread, so it goes wide
template <typename T>
__device__ __forceinline__ void stage(const T* x, int n, float* h_s) {
#pragma unroll 4
  for (int e = threadIdx.x * 8; e < n; e += THREADS * 8) {
    float w[8];
    load8(x + e, w);
    *reinterpret_cast<float4*>(h_s + e) = make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(h_s + e + 4) = make_float4(w[4], w[5], w[6], w[7]);
  }
}

// h = LN(x) rounded to T: x staged once, one warp per row for the fp32
// statistics (mean, then the variance about it), then normalised in place
template <typename T>
__device__ void ln_prologue(const GemvParams& p, float* h_s, float* stats) {
  const int B = p.B, K = p.K;
  stage(static_cast<const T*>(p.x), B * K, h_s);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += WARPS) {
    const float* row = h_s + b * K;
    float s = 0.f;
    for (int e = lane; e < K; e += 32) s += row[e];
    const float mean = warp_sum(s) / K;
    float ss = 0.f;
    for (int e = lane; e < K; e += 32) {
      const float d = row[e] - mean;
      ss += d * d;
    }
    const float var = warp_sum(ss) / K;
    if (lane == 0) {
      stats[2 * b] = mean;
      stats[2 * b + 1] = rsqrtf(var + 1e-5f);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < B * K; e += THREADS) {
    const int b = e / K, k = e - b * K;
    h_s[e] = round_t<T>((h_s[e] - stats[2 * b]) * stats[2 * b + 1] * p.ln_s[k] + p.ln_b[k]);
  }
}

template <typename T>
__device__ __forceinline__ void epilogue(const GemvParams& p, const Proj& pr, int b, int n,
                                         float v) {
  const long long i = (long long)b * p.N + n;
  const T* bias = static_cast<const T*>(pr.bias);
  if (pr.w8) v = __fmul_rn(v, pr.w_scale[n]);  // the int8 scale commutes through the sum
  switch (pr.epi) {
    case EPI_Q:
      static_cast<float*>(pr.out)[i] = (v + to_f(bias[n])) * p.q_scale;
      return;
    case EPI_BIAS:
      v += to_f(bias[n]);
      break;
    case EPI_GELU:
      v += to_f(bias[n]);
      v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      break;
    case EPI_RESID:
      v += to_f(bias[n]) + to_f(static_cast<const T*>(p.resid)[i]);
      break;
    default:  // EPI_PLAIN
      break;
  }
  static_cast<T*>(pr.out)[i] = from_f<T>(v);
}

// acc[b][c] += sum over this thread's k of h[b, k] W[k, n0 + c]; W already
// offset to the thread's 8 columns
template <typename WT, int MAXB>
__device__ __forceinline__ void gemv_accumulate(const WT* W, const float* h_s, int B, int K,
                                                int N, int kl, float (&acc)[MAXB][VEC]) {
#pragma unroll 8
  for (int k = kl; k < K; k += KL) {
    float w[VEC];
    load8(W + (long long)k * N, w);
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const float hv = h_s[b * K + k];
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[b][c] = fmaf(hv, w[c], acc[b][c]);
      }
    }
  }
}

template <typename T, int MAXB>
__global__ void __launch_bounds__(THREADS) gemv_kernel(const GemvParams p) {
  extern __shared__ float4 h_s4[];              // (B, K) prologue output
  float* h_s = reinterpret_cast<float*>(h_s4);  // (float4: 16-byte aligned)
  __shared__ float red[WARPS][MAXB][NB];
  __shared__ float stats[2 * MAXB];
  const int tid = threadIdx.x;
  const int B = p.B, K = p.K, N = p.N;

  if (p.prologue == PRO_LN) {
    ln_prologue<T>(p, h_s, stats);
  } else {
    stage(static_cast<const T*>(p.x), B * K, h_s);
  }
  __syncthreads();

  const Proj& pr = p.proj[blockIdx.y];
  const int kl = tid / CL, cl = tid % CL;
  const int n0 = blockIdx.x * NB;

  float acc[MAXB][VEC];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[b][c] = 0.f;

  if (pr.w8) {
    gemv_accumulate<int8_t, MAXB>(static_cast<const int8_t*>(pr.w) + n0 + cl * VEC, h_s, B, K,
                                  N, kl, acc);
  } else {
    gemv_accumulate<T, MAXB>(static_cast<const T*>(pr.w) + n0 + cl * VEC, h_s, B, K, N, kl, acc);
  }

  // the 16 k-lanes of a warp differ in lane bits 1..4
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < B) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float a = acc[b][c];
#pragma unroll
        for (int o = CL; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane < CL) red[warp][b][lane * VEC + c] = a;
      }
    }
  }
  __syncthreads();
  if (tid < B * NB) {
    const int b = tid / NB, c = tid % NB;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][b][c];
    epilogue<T>(p, pr, b, n0 + c, s);
  }
}

// One block per (256-key chunk, head, row): chunk-local softmax partials.
// part[b, h, chunk] = (acc[64] = sum_t p_t v_t, m, l = sum_t p_t), p_t =
// exp(s_t - m) over the chunk's valid keys t < n_valid. Lane (kg, dl) of a
// warp reads dims dl*8..dl*8+7 of key row base + kg: a key row is 8 lanes
// x 16 bytes, a warp reads 4 rows per pass.
template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attn_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part, int d,
                    long long kv_bstride, int n_valid, int n_split) {
  __shared__ float p_s[CHUNK];
  __shared__ float acc_s[ATT_WARPS][HD];
  __shared__ float red[ATT_WARPS];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane / KEY_LANES, dl = lane % KEY_LANES;
  float* out = part + ((long long)(b * H + h) * n_split + s) * (HD + 2);
  const int t0 = s * CHUNK;
  const int t1 = min(t0 + CHUNK, n_valid);
  if (t0 >= t1) {  // a chunk wholly past the valid keys contributes nothing
    if (tid < HD) out[tid] = 0.f;
    if (tid == 0) {
      out[HD] = NEG;
      out[HD + 1] = 0.f;
    }
    return;
  }
  float qv[8];  // q arrives fp32, pre-scaled by 64^-0.5; cast to the K dtype
#pragma unroll
  for (int c = 0; c < 8; ++c) qv[c] = round_t<T>(q[(long long)b * d + h * HD + dl * 8 + c]);

  const T* kb = k + b * kv_bstride + h * HD + dl * 8;
  const T* vb = v + b * kv_bstride + h * HD + dl * 8;
  // the loop bound is warp-uniform so every lane reaches the shuffles
  float m_loc = NEG;
#pragma unroll 4
  for (int base = t0 + warp * (KEY_STEP / ATT_WARPS); base < t1; base += KEY_STEP) {
    const int t = base + kg;
    float dot = 0.f;
    if (t < t1) {
      float w[8];
      load8(kb + (long long)t * d, w);
#pragma unroll
      for (int c = 0; c < 8; ++c) dot = fmaf(w[c], qv[c], dot);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (t < t1) {
      if (dl == 0) p_s[t - t0] = dot;
      m_loc = fmaxf(m_loc, dot);
    }
  }
  const float m = block_reduce<true>(m_loc, red);   // also orders the p_s writes
  float l_loc = 0.f;
  for (int t = t0 + tid; t < t1; t += ATT_THREADS) {
    const float e = expf(p_s[t - t0] - m);
    l_loc += e;                       // the sum takes p in fp32 ...
    p_s[t - t0] = round_t<T>(e);      // ... p@v takes p in the V dtype
  }
  const float l = block_reduce<false>(l_loc, red);

  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int base = t0 + warp * (KEY_STEP / ATT_WARPS); base < t1; base += KEY_STEP) {
    const int t = base + kg;
    if (t < t1) {
      float w[8];
      load8(vb + (long long)t * d, w);
      const float pt = p_s[t - t0];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(pt, w[c], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // sum the warp's 4 key groups
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 8);
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 16);
  }
  if (kg == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc_s[warp][dl * 8 + c] = acc[c];
  }
  __syncthreads();
  if (tid < HD) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < ATT_WARPS; ++w) a += acc_s[w][tid];
    out[tid] = a;
  }
  if (tid == 0) {
    out[HD] = m;
    out[HD + 1] = l;
  }
}

// o[b, h*64 + j] = sum_s acc_s[j] e^(m_s - M) / sum_s l_s e^(m_s - M), cast to
// T (the Pallas kernel's o.astype(x.dtype) before @wo). One block per (head, row).
template <typename T>
__global__ void __launch_bounds__(HD)
attn_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int d, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const float* base = part + (long long)(b * gridDim.x + h) * n_split * (HD + 2);
  float M = NEG;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, base[s * (HD + 2) + HD]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(base[s * (HD + 2) + HD] - M);
    L += base[s * (HD + 2) + HD + 1] * w;
    A += base[s * (HD + 2) + j] * w;
  }
  o[(long long)b * d + h * HD + j] = from_f<T>(A / L);
}

template <typename T, int MAXB>
cudaError_t gemv_launch(const GemvParams& p, int n_proj, cudaStream_t stream) {
  // raise the dynamic shared-memory cap whenever a call needs more than the
  // last one set on this device (static + dynamic may exceed the 48 KB
  // default only so); the attribute is per device, so is the cache
  constexpr int MAX_DEVICES = 64;
  static int smem_max[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int smem = p.B * p.K * (int)sizeof(float);
  if (dev >= MAX_DEVICES || smem > smem_max[dev]) {
    e = cudaFuncSetAttribute(gemv_kernel<T, MAXB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) smem_max[dev] = smem;
  }
  gemv_kernel<T, MAXB><<<dim3(p.N / NB, n_proj), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Any number of rows, in groups of at most MAX_ROWS (a group's inputs are
// staged in shared memory: 8 x 5120 fp32 = 160 KB for fc2); each group
// streams the weights once.
template <typename T>
cudaError_t gemv(const GemvParams& p, int n_proj, cudaStream_t stream) {
  if (p.B < 1) return cudaErrorInvalidValue;
  for (int b0 = 0; b0 < p.B; b0 += MAX_ROWS) {
    GemvParams g = p;
    g.B = min(MAX_ROWS, p.B - b0);
    g.x = static_cast<const T*>(p.x) + (long long)b0 * p.K;
    if (p.resid != nullptr) g.resid = static_cast<const T*>(p.resid) + (long long)b0 * p.N;
    for (int i = 0; i < n_proj; ++i) {
      const long long off = (long long)b0 * p.N;
      g.proj[i].out = p.proj[i].epi == EPI_Q
                          ? static_cast<void*>(static_cast<float*>(p.proj[i].out) + off)
                          : static_cast<void*>(static_cast<T*>(p.proj[i].out) + off);
    }
    const cudaError_t e = g.B <= 4 ? gemv_launch<T, 4>(g, n_proj, stream)
                                   : gemv_launch<T, MAX_ROWS>(g, n_proj, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

GemvParams base_params(int B, int K, int N, int prologue, const void* x, const float* ln_s,
                       const float* ln_b) {
  GemvParams p{};
  p.B = B;
  p.K = K;
  p.N = N;
  p.prologue = prologue;
  p.x = x;
  p.ln_s = ln_s;
  p.ln_b = ln_b;
  p.q_scale = 0.125f;  // 64^-0.5
  return p;
}

template <typename T>
cudaError_t qkv(const void* x, const float* ln_s, const float* ln_b, const void* wq,
                const void* bq, const void* wk, const void* wv, const void* bv,
                const float* sq, const float* sk, const float* sv, float* q_out,
                void* k_out, void* v_out, int B, int d, cudaStream_t st) {
  GemvParams p = base_params(B, d, d, PRO_LN, x, ln_s, ln_b);
  p.proj[0] = proj(wq, bq, q_out, EPI_Q, sq);
  p.proj[1] = proj(wk, nullptr, k_out, EPI_PLAIN, sk);
  p.proj[2] = proj(wv, bv, v_out, EPI_BIAS, sv);
  return gemv<T>(p, 3, st);
}

template <typename T>
cudaError_t attn(const void* x, const float* q_in, const float* ln_s, const float* ln_b,
                 const void* wq, const void* bq, const void* k, const void* v,
                 const void* wo, const void* bo, const float* sq, const float* so,
                 float* q_buf, float* part, void* o_buf, void* out, int B, int T_len, int d,
                 int n_valid, cudaStream_t st) {
  const float* q = q_in;
  if (q == nullptr) {  // cross mode: q = (LN(x)@wq + bq) * 64^-0.5
    GemvParams pq = base_params(B, d, d, PRO_LN, x, ln_s, ln_b);
    pq.proj[0] = proj(wq, bq, q_buf, EPI_Q, sq);
    const cudaError_t e = gemv<T>(pq, 1, st);
    if (e != cudaSuccess) return e;
    q = q_buf;
  }
  const int n_split = (T_len + CHUNK - 1) / CHUNK;
  attn_partial_kernel<T><<<dim3(n_split, d / HD, B), ATT_THREADS, 0, st>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), part, d, (long long)T_len * d,
      n_valid, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_combine_kernel<T><<<dim3(d / HD, B), HD, 0, st>>>(part, static_cast<T*>(o_buf), d,
                                                         n_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  GemvParams po = base_params(B, d, d, PRO_INPUT, o_buf, nullptr, nullptr);
  po.resid = x;
  po.proj[0] = proj(wo, bo, out, EPI_RESID, so);
  return gemv<T>(po, 1, st);
}

template <typename T>
cudaError_t mlp(const void* x, const float* ln_s, const float* ln_b, const void* w1,
                const void* b1, const void* w2, const void* b2, const float* s1,
                const float* s2, void* g_buf, void* out, int B, int d, int ff,
                cudaStream_t st) {
  GemvParams p1 = base_params(B, d, ff, PRO_LN, x, ln_s, ln_b);
  p1.proj[0] = proj(w1, b1, g_buf, EPI_GELU, s1);
  cudaError_t e = gemv<T>(p1, 1, st);
  if (e != cudaSuccess) return e;
  GemvParams p2 = base_params(B, ff, d, PRO_INPUT, g_buf, nullptr, nullptr);
  p2.resid = x;
  p2.proj[0] = proj(w2, b2, out, EPI_RESID, s2);
  return gemv<T>(p2, 1, st);
}

}  // namespace

// C entries. dtype: 0 = float32, 1 = bfloat16 (activations, float weights,
// biases and caches); LN scale/bias and q are fp32. A weight whose scale
// pointer (sq, sk, sv, so, s1, s2: (N,) fp32) is non-null is int8. Pointers
// are already offset to the layer; every (B, n) array is contiguous.
// Scratch: q_buf (B, d) fp32, part (B, d/64, ceil(T/256), 66) fp32, o_buf
// (B, d) and g_buf (B, ff) in dtype.

extern "C" int fused_qkv_fwd(int dtype, const void* x, const float* ln_s, const float* ln_b,
                             const void* wq, const void* bq, const void* wk, const void* wv,
                             const void* bv, const float* sq, const float* sk, const float* sv,
                             float* q_out, void* k_out, void* v_out, int B, int d,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? qkv<float>(x, ln_s, ln_b, wq, bq, wk, wv, bv, sq, sk, sv, q_out, k_out,
                              v_out, B, d, st)
                 : qkv<__nv_bfloat16>(x, ln_s, ln_b, wq, bq, wk, wv, bv, sq, sk, sv, q_out,
                                      k_out, v_out, B, d, st));
}

extern "C" int fused_attn_fwd(int dtype, const void* x, const float* q, const float* ln_s,
                              const float* ln_b, const void* wq, const void* bq, const void* k,
                              const void* v, const void* wo, const void* bo, const float* sq,
                              const float* so, float* q_buf, float* part, void* o_buf,
                              void* out, int B, int T_len, int d, int n_valid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? attn<float>(x, q, ln_s, ln_b, wq, bq, k, v, wo, bo, sq, so, q_buf, part,
                               o_buf, out, B, T_len, d, n_valid, st)
                 : attn<__nv_bfloat16>(x, q, ln_s, ln_b, wq, bq, k, v, wo, bo, sq, so, q_buf,
                                       part, o_buf, out, B, T_len, d, n_valid, st));
}

extern "C" int fused_mlp_fwd(int dtype, const void* x, const float* ln_s, const float* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const float* s1, const float* s2, void* g_buf, void* out, int B,
                             int d, int ff, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? mlp<float>(x, ln_s, ln_b, w1, b1, w2, b2, s1, s2, g_buf, out, B, d, ff, st)
                 : mlp<__nv_bfloat16>(x, ln_s, ln_b, w1, b1, w2, b2, s1, s2, g_buf, out, B, d,
                                      ff, st));
}
