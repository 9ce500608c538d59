// Fused per-token decoder kernels, written by hand for Hopper (sm_90a).
//
// Replaces four Pallas kernels of asr_finetune_tpu/ops/decoder_fused.py:
//   fused_qkv  (:150, pl.pallas_call :195, kernel _qkv_kernel :127)
//       LN(x) -> q = (h@wq + bq) * 64^-0.5 in fp32, k = h@wk, v = h@wv + bv
//   fused_attn (:310, pl.pallas_call :447, kernel _attn_kernel :213)
//       self mode: q given, keys at col > pos masked; cross mode: q =
//       (LN(x)@wq + bq) * 64^-0.5 computed here, keys at col >= s_valid
//       masked; softmax attention, then out = o@wo + bo + x. Options: int8
//       K/V with per-(row, head) scales (k_scale/v_scale, :237-243,
//       :288-292) and kv_group G query rows sharing one KV row (the beam
//       hypotheses of an utterance over its cross K/V, :334-357; any G, where
//       the Pallas kernel takes G <= 8)
//   fused_attn_beam (:548, pl.pallas_call :630, kernel _attn_beam_kernel
//       :484): beam self-attention over an unpermuted (B*K, T, d) cache,
//       position t of hypothesis (b, k) read from row b*K + anc[b, k, t];
//       then out = o@wo + bo + x
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
//    (row, head) into o, which the wo GEMV reads as its input. With
//    kv_group G a block serves up to 8 query rows of one KV row, so a shared
//    cross K/V chunk is read once per 8 rows, not G times (G x fewer bytes on
//    the decode's largest read up to 8 beams); int8 K/V halves those bytes
//    again. The beam
//    kernel is the same block reading each key row through the ancestry
//    map: T rows per query, never the K*T the Pallas kernel masks over.
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
constexpr int MAX_GROUP = 8;             // query rows of one KV row per attention block
constexpr int ATT_THREADS = 128;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int KEY_LANES = 8;             // lanes per key row (8 x 8 dims)
constexpr int KEY_STEP = ATT_THREADS / KEY_LANES;  // keys per pass of a block

// launches of each kernel since the last reset, counted on the host where
// the launch is made (gemv, attn_partial, attn_combine): chip_smoke.py holds
// a decode step's counts to what its rows and layers imply
enum Kernel { K_GEMV = 0, K_PARTIAL = 1, K_COMBINE = 2, N_KERNELS = 3 };
long long g_launches[N_KERNELS] = {};

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

// What attn_partial_kernel reads. The query rows come in groups of G >= 1:
// group z holds rows z*G .. z*G+G-1, which share KV row z (kv_group, the beam
// hypotheses of one utterance over its cross K/V; G = 1 is one query row per
// KV row). A block serves gs = min(G, MAX_GROUP) rows of a group (its
// register arrays hold that many queries), so a group takes n_sub =
// ceil(G / gs) blocks, the last one maybe fewer rows. With `anc` (beam
// self-attention, G = 1) the key at position t of query row r lives in cache
// row (r - r % beam) + anc[r, t] instead.
struct AttnArgs {
  const float* q;        // (N, d) fp32, pre-scaled by 64^-0.5
  const void* k;         // KV rows of kv_bstride elements: T, or int8 with scales
  const void* v;
  const float* k_scale;  // int8 KV: (N / G, d) fp32 per-(row, head) scales, else null
  const int* anc;        // beam: (N, T_len) int32 ancestry, else null
  float* part;           // (N, d/64, n_split, 66)
  long long kv_bstride;  // elements from one KV row to the next (T_len * d)
  int d, T_len, n_valid, n_split, G, gs, n_sub, beam;
};

// Sum (or max) of each of the first G entries of v over the block, in place;
// buf holds MAXG floats per warp. The trailing sync lets a second call reuse
// buf. For G = 1 this is block_reduce.
template <bool MAX, int MAXG>
__device__ __forceinline__ void group_reduce(float (&v)[MAXG], int G, float (*buf)[MAXG]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) v[g] = MAX ? warp_max(v[g]) : warp_sum(v[g]);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) buf[warp][g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      float r = MAX ? NEG : 0.f;
      for (int i = 0; i < ATT_WARPS; ++i) r = MAX ? fmaxf(r, buf[i][g]) : r + buf[i][g];
      v[g] = r;
    }
  }
  __syncthreads();
}

// One block per (256-key chunk, head, gs query rows of a group): chunk-local
// softmax partials. part[r, h, chunk] = (acc[64] = sum_t p_t v_t, m, l =
// sum_t p_t), p_t = exp(s_t - m) over the chunk's valid keys t < n_valid.
// Lane (kg, dl) of a warp reads dims dl*8..dl*8+7 of key row base + kg: a key
// row is 8 lanes x 16 bytes (8 bytes in int8), a warp reads 4 rows per pass.
// Each K and V element of the chunk is loaded once per block, into
// registers, and every query of the block takes its product from there: the
// up to 8 queries sharing a KV row cost one read of it, not 8. KV is T, or int8
// (exact in any float type): then K's per-(row, head) scale is folded into q
// once per row (the Pallas kernel's q * ksc, :237-243) and V's multiplies the
// combined accumulator (attn_combine_kernel), so the chunk pays only the
// int8 -> float conversion. With anc the block gathers each key row from the
// cache row the ancestry names: a pointer offset per key, T rows per query,
// where the Pallas kernel scored all K*T rows of the group and masked all
// but the live one (Mosaic cannot gather).
template <typename T, typename KV, int MAXG>
__global__ void __launch_bounds__(ATT_THREADS) attn_partial_kernel(const AttnArgs a) {
  __shared__ float p_s[MAXG][CHUNK];
  __shared__ float acc_s[ATT_WARPS][MAXG][HD];
  __shared__ float red[ATT_WARPS][MAXG];
  const int s = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int grp = blockIdx.z / a.n_sub, sub = blockIdx.z % a.n_sub;  // KV row, part
  const int G = min(a.gs, a.G - sub * a.gs), d = a.d;                // this block's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane / KEY_LANES, dl = lane % KEY_LANES;
  const int r0 = grp * a.G + sub * a.gs;  // the block's first query row
  const int t0 = s * CHUNK;
  const int t1 = min(t0 + CHUNK, a.n_valid);
  auto out_row = [&](int g) {
    return a.part + ((long long)((r0 + g) * H + h) * a.n_split + s) * (HD + 2);
  };
  if (t0 >= t1) {  // a chunk wholly past the valid keys contributes nothing
    for (int g = 0; g < G; ++g) {
      float* out = out_row(g);
      if (tid < HD) out[tid] = 0.f;
      if (tid == 0) {
        out[HD] = NEG;
        out[HD + 1] = 0.f;
      }
    }
    return;
  }
  const int col = h * HD + dl * 8;
  // q arrives fp32, pre-scaled by 64^-0.5; times K's scale for int8 KV; cast
  // to the dtype the product runs in (the K dtype, or T for int8 KV)
  float qv[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float qq = 0.f;
      if (g < G) {
        qq = a.q[(long long)(r0 + g) * d + col + c];
        if (a.k_scale != nullptr) qq *= a.k_scale[(long long)grp * d + col + c];
      }
      qv[g][c] = round_t<T>(qq);
    }
  }
  const KV* kb = static_cast<const KV*>(a.k) + col;
  const KV* vb = static_cast<const KV*>(a.v) + col;
  // the KV row holding key t: the group's own, or the one the ancestry names
  auto kv_off = [&](int t) -> long long {
    const long long row =
        a.anc == nullptr ? grp : (r0 - r0 % a.beam) + a.anc[(long long)r0 * a.T_len + t];
    return row * a.kv_bstride + (long long)t * d;
  };

  // the loop bound is warp-uniform so every lane reaches the shuffles
  float m[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) m[g] = NEG;
#pragma unroll 2
  for (int base = t0 + warp * (KEY_STEP / ATT_WARPS); base < t1; base += KEY_STEP) {
    const int t = base + kg;
    float dot[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
    if (t < t1) {
      float w[8];
      load8(kb + kv_off(t), w);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
#pragma unroll
          for (int c = 0; c < 8; ++c) dot[g] = fmaf(w[c], qv[g][c], dot[g]);
        }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 1);
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 2);
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 4);
        if (t < t1) {
          if (dl == 0) p_s[g][t - t0] = dot[g];
          m[g] = fmaxf(m[g], dot[g]);
        }
      }
    }
  }
  group_reduce<true, MAXG>(m, G, red);  // also orders the p_s writes
  float l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) l[g] = 0.f;
  for (int t = t0 + tid; t < t1; t += ATT_THREADS) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float e = expf(p_s[g][t - t0] - m[g]);
        l[g] += e;                        // the sum takes p in fp32 ...
        p_s[g][t - t0] = round_t<T>(e);   // ... p@v takes p in the V (compute) dtype
      }
    }
  }
  group_reduce<false, MAXG>(l, G, red);

  float acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[g][c] = 0.f;
#pragma unroll 2
  for (int base = t0 + warp * (KEY_STEP / ATT_WARPS); base < t1; base += KEY_STEP) {
    const int t = base + kg;
    if (t < t1) {
      float w[8];
      load8(vb + kv_off(t), w);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float pt = p_s[g][t - t0];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[g][c] = fmaf(pt, w[c], acc[g][c]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // sum the warp's 4 key groups
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], 8);
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], 16);
      }
      if (kg == 0) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc_s[warp][g][dl * 8 + c] = acc[g][c];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += ATT_THREADS) {
    const int g = i / HD, j = i - g * HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < ATT_WARPS; ++w) sum += acc_s[w][g][j];
    out_row(g)[j] = sum;
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G && tid == g) {
      out_row(g)[HD] = m[g];
      out_row(g)[HD + 1] = l[g];
    }
  }
}

// o[r, h*64 + j] = sum_s acc_s[j] e^(m_s - M) [x v_scale] / sum_s l_s e^(m_s
// - M), cast to T (the Pallas kernel's acc * vsc, then o.astype(x.dtype)
// before @wo). One block per (head, query row); v_scale, for int8 V, is
// (N / G, d) like k_scale.
template <typename T>
__global__ void __launch_bounds__(HD)
attn_combine_kernel(const float* __restrict__ part, const float* __restrict__ v_scale,
                    T* __restrict__ o, int d, int n_split, int G) {
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
  if (v_scale != nullptr) A *= v_scale[(long long)(b / G) * d + h * HD + j];
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
  ++g_launches[K_GEMV];
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

template <typename T, typename KV>
cudaError_t attn_partial(const AttnArgs& a, int n_groups, cudaStream_t st) {
  const dim3 grid(a.n_split, a.d / HD, n_groups * a.n_sub);
  if (a.gs == 1) {
    attn_partial_kernel<T, KV, 1><<<grid, ATT_THREADS, 0, st>>>(a);
  } else if (a.gs == 2) {
    attn_partial_kernel<T, KV, 2><<<grid, ATT_THREADS, 0, st>>>(a);
  } else if (a.gs <= 4) {
    attn_partial_kernel<T, KV, 4><<<grid, ATT_THREADS, 0, st>>>(a);
  } else {
    attn_partial_kernel<T, KV, MAX_GROUP><<<grid, ATT_THREADS, 0, st>>>(a);
  }
  ++g_launches[K_PARTIAL];
  return cudaGetLastError();
}

// Attention of N query rows (q given, or computed from x in cross mode) over
// the KV rows `a` describes, then out = o@wo + bo + x.
template <typename T>
cudaError_t attn(const void* x, const float* ln_s, const float* ln_b, const void* wq,
                 const void* bq, const float* sq, AttnArgs a, const float* v_scale,
                 const void* wo, const void* bo, const float* so, float* q_buf, void* o_buf,
                 void* out, int N, cudaStream_t st) {
  const int d = a.d;
  if (N < 1 || a.G < 1 || N % a.G != 0 ||
      (a.anc != nullptr && (a.G != 1 || a.beam < 1 || N % a.beam != 0)))
    return cudaErrorInvalidValue;
  if (a.q == nullptr) {  // cross mode: q = (LN(x)@wq + bq) * 64^-0.5
    GemvParams pq = base_params(N, d, d, PRO_LN, x, ln_s, ln_b);
    pq.proj[0] = proj(wq, bq, q_buf, EPI_Q, sq);
    const cudaError_t e = gemv<T>(pq, 1, st);
    if (e != cudaSuccess) return e;
    a.q = q_buf;
  }
  cudaError_t e = a.k_scale != nullptr ? attn_partial<T, int8_t>(a, N / a.G, st)
                                       : attn_partial<T, T>(a, N / a.G, st);
  if (e != cudaSuccess) return e;
  attn_combine_kernel<T><<<dim3(d / HD, N), HD, 0, st>>>(a.part, v_scale, static_cast<T*>(o_buf),
                                                         d, a.n_split, a.G);
  ++g_launches[K_COMBINE];
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  GemvParams po = base_params(N, d, d, PRO_INPUT, o_buf, nullptr, nullptr);
  po.resid = x;
  po.proj[0] = proj(wo, bo, out, EPI_RESID, so);
  return gemv<T>(po, 1, st);
}

AttnArgs attn_args(const float* q, const void* k, const void* v, const float* k_scale,
                   const int* anc, float* part, int T_len, int d, int n_valid, int G,
                   int beam) {
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = k_scale;
  a.anc = anc;
  a.part = part;
  a.kv_bstride = (long long)T_len * d;
  a.d = d;
  a.T_len = T_len;
  a.n_valid = n_valid;
  a.n_split = (T_len + CHUNK - 1) / CHUNK;
  a.G = G;
  a.gs = min(G, MAX_GROUP);
  a.n_sub = (G + a.gs - 1) / a.gs;
  a.beam = beam;
  return a;
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
// (B, d) and g_buf (B, ff) in dtype. fused_attn: N query rows over N / G
// KV rows of T_len positions; k/v int8 when k_scale/v_scale ((N / G, d)
// fp32) are non-null.

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
                              const void* v, const float* k_scale, const float* v_scale,
                              const void* wo, const void* bo, const float* sq, const float* so,
                              float* q_buf, float* part, void* o_buf, void* out, int N,
                              int T_len, int d, int n_valid, int G, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnArgs a = attn_args(q, k, v, k_scale, nullptr, part, T_len, d, n_valid, G, 1);
  return static_cast<int>(
      dtype == 0 ? attn<float>(x, ln_s, ln_b, wq, bq, sq, a, v_scale, wo, bo, so, q_buf, o_buf,
                               out, N, st)
                 : attn<__nv_bfloat16>(x, ln_s, ln_b, wq, bq, sq, a, v_scale, wo, bo, so, q_buf,
                                       o_buf, out, N, st));
}

// Beam self-attention over the unpermuted cache: anc (N, T_len) int32, the
// (B, beam, T_len) ancestry map; query row r reads position t from cache row
// (r - r % beam) + anc[r, t].
extern "C" int fused_attn_beam_fwd(int dtype, const void* x, const float* q, const void* k,
                                   const void* v, const int* anc, const void* wo,
                                   const void* bo, const float* so, float* part, void* o_buf,
                                   void* out, int N, int T_len, int d, int n_valid, int beam,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnArgs a = attn_args(q, k, v, nullptr, anc, part, T_len, d, n_valid, 1, beam);
  return static_cast<int>(
      dtype == 0 ? attn<float>(x, nullptr, nullptr, nullptr, nullptr, nullptr, a, nullptr, wo,
                               bo, so, nullptr, o_buf, out, N, st)
                 : attn<__nv_bfloat16>(x, nullptr, nullptr, nullptr, nullptr, nullptr, a,
                                       nullptr, wo, bo, so, nullptr, o_buf, out, N, st));
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

// out[3] = launches of gemv_kernel, attn_partial_kernel, attn_combine_kernel
// since the last reset
extern "C" void kernel_launches(long long* out) {
  for (int i = 0; i < N_KERNELS; ++i) out[i] = g_launches[i];
}

extern "C" void reset_kernel_launches() {
  for (int i = 0; i < N_KERNELS; ++i) g_launches[i] = 0;
}
