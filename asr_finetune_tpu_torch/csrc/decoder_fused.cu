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
// attention, its K/V rows): at B=4 every weight element feeds 8 flops
// against 2 bytes (bf16), ~4 flop per byte against the ~295 the H100 needs
// before its tensor cores limit. Everything is built to stream:
//
//  * gemv_kernel (the fp32 route: fused_qkv, fused_attn's q and wo,
//    fused_attn_beam's wo, fused_mlp; bf16 calls run the tensor cores):
//    out[b, n] = sum_k h[b, k] W[k, n] for all rows of a group at once, so
//    each weight byte is read once per group. A block owns 16 output columns
//    and splits K over 128 lanes (16-byte loads, 8 columns per thread),
//    reduced by warp shuffles and one shared-memory pass, on the CUDA cores.
//    Its prologue stages h in shared memory once (LN(x): x staged, one warp
//    per row for the statistics; or an input row as it is) and its epilogue
//    applies the bias, scale, GELU or residual of the projection. One launch
//    serves up to three projections (blockIdx.y), so fused_qkv is one
//    launch. Accumulators for 4 rows when B <= 4, else 8; more rows run as
//    groups of 8, one launch each.
//  * qkv_kernel (bf16 fused_qkv): one programmatic dependent launch a pass of
//    up to 32 rows, the three projections the MLP's tensor-core product with
//    an LN prologue (as the cross q's). The GEMV held fused_qkv at 4.6x its
//    bound with fixed costs: one launch for each group of 8 rows (two at the
//    beam path's 16, each reading the 9.8 MB of weights again), on the CUDA
//    cores, and two more copies a layer to put k and v into the cache. Here
//    the grid is 3 x d/64 column tiles, K split so that it is one wave
//    (large-v3: 60 x 2 blocks); a block takes its projection from its tile,
//    the weight from that projection's cached tensor map (the layer a TMA
//    coordinate) and its type too, so int8 and float projections mix in one
//    launch (a merged PEFT base: int8 k beside float q and v). The epilogue
//    writes q in fp32 and k and v in bf16 straight into the self cache's
//    row pos (a row stride of T x d), so the step copies nothing. Before
//    griddepcontrol.wait only the layer's parameters load, which no kernel
//    writes (the weight stream; the biases, scales and LN's scale and bias,
//    whose round trip so leaves the critical path); x (by TMA boxes that
//    land swizzled, not by cp.async: 120 blocks read the same rows), the
//    partial sums, the tickets and the cache rows all come after it, and the
//    self core that follows issues its K/V boxes only after its own wait.
//    What bounds it: not the 9.8 MB weight stream (2.9 us) but fixed costs:
//    LN(x) at ~1.3 us a row a warp (its fp32 -> fp64 conversions' latency),
//    the split sums' round trip, the launch.
//  * mlp_fc1_kernel, mlp_fc2_kernel (bf16 fused_mlp): the two products on
//    the tensor cores, one launch each a pass of up to 32 rows. The GEMVs
//    held fused_mlp at 5.7x its bound with fixed costs, not flops: two
//    launches restaging their inputs, fc2 on 80 blocks, the weights read
//    again for each group of 8 rows. Here the weight tile is wgmma's A
//    operand, 64 output columns x k, read MN-major (the bf16 transpose bit)
//    straight from its 128-byte-swizzled TMA box; the decode rows are N,
//    padded to 8, 16 or 32, so 4 rows waste no 64-row M tile and up to 32
//    rows cost one read of the weights (more rows take further passes). A
//    producer warp streams the block's weight tile through an mbarrier ring
//    from the first cycle (the weights depend on no earlier kernel; the
//    tensor maps of the stacked (L, K, N) weights are encoded once per
//    weight and cached, the layer a TMA coordinate). The activations load
//    through cp.async, not behind the weights in the TMA unit's queue: fc1
//    x's whole rows, normalised in place (fp32 statistics, a warp a row,
//    LN(x) rounded to bf16), fc2 g's k range. An int8 stage lands
//    unswizzled and is widened exactly to a swizzled bf16 tile on the ALU
//    before its products (wgmma cannot transpose int8); its scale multiplies
//    the fp32 sum. The grid is (N / 64) x splits of K, splits = SMs / tiles,
//    one wave (large-v3: fc1 80 x 1, fc2 20 x 6); a tile's split sums go
//    through a partial buffer and its last block, found by a release /
//    acquire ticket that resets itself, adds them in split order: the same
//    bits every call, CUDA-graph safe. Both are programmatic dependent
//    launches: fc1 lets fc2 start at once, so fc2's blocks that find an SM
//    stream W2 while fc1 runs, and each waits (griddepcontrol.wait) only
//    before its activations. What bounds it on the card: not the weight
//    stream (at 4 rows one call moves 26 MB, 7.8 us at 3.35 TB/s) but the
//    round trips to the L2 that the memory system, loaded by that stream,
//    makes slow: the activations, the split-K ticket and sums, g between
//    the two kernels.
//  * attn_q_kernel, attn_chunk_kernel, attn_wo_kernel (bf16 fused_attn):
//    three programmatic dependent launches a pass of up to 32 rows (self
//    mode: the last two). The GEMV route spent most of a call in fixed
//    costs: two to four GEMV launches of ~11 us (one a group of 8 rows),
//    the combine a launch of its own, K read 16 bytes a lane through three
//    dependent shuffles a key, V only after the chunk's softmax, nothing
//    overlapped. Here the cross q (LN(x), then (v s + bq) 64^-0.5 in fp32)
//    and wo ((v s + bo) + x) are the MLP's tensor-core products, the
//    weights streamed through the TMA ring from the cached map of the
//    stacked (L, d, d) weight, K split six ways at large-v3 (20 x 6
//    blocks). The attention core is a block per (KV row, head, chunk of
//    256 keys, up to 8 query rows of the KV row) that issues its K and V
//    chunk as 64-key TMA boxes at entry (cross mode: before the wait for q,
//    which the cross K/V do not depend on) and takes the scores and p.v on
//    the tensor cores (mma.sync m16n8k16, the query rows as M, 8 of 16
//    used); the combine of a (rows, head)'s chunks runs in its last
//    chunk's block (found by a self-resetting ticket; a single chunk is its
//    own combine) and writes o in bf16, so wo loads o as fc2 loads g. The q
//    product lets the core start at once, the core lets wo start, so wo
//    streams while the attention runs.
//  * attn_chunk_kernel in beam mode, attn_wo_kernel (bf16 fused_attn_beam):
//    two programmatic dependent launches a pass of up to 32 rows (q comes
//    from fused_qkv). The GEMV route held it at 13x its bound with fixed
//    costs: four launches a layer (the partials, their combine, the wo
//    GEMV once per group of 8 rows, each group reading wo's 3.3 MB again),
//    the scores on the CUDA cores, 8 lanes a key through three dependent
//    shuffles, nothing overlapped. What bounds it is bytes (the distinct
//    live cache rows, wo, x) but at 16 rows it moves ~7 MB, ~2 us at 3.35
//    TB/s: fixed costs still dominate. Here it is the cross and self
//    attention's core and wo product: a block per (query row, head, chunk
//    of 256 keys) gathers each key row of its head, 128 bytes of K and of V,
//    from the cache row the ancestry names (cp.async, 16 bytes a thread,
//    into the swizzled tile TMA would land, K and V on barriers of their
//    own), and the scores and p.v on the tensor cores, the ticketed combine
//    and o in bf16 are the self core's, unchanged; wo streams while the
//    core runs. Only chunks with valid keys are read: T rows a query, never
//    the K x T the Pallas kernel masks over.
//  * attn_partial_kernel (fp32 fused_attn, fused_attn_beam): split-T
//    flash-decoding. The TPU kernel's grid of B
//    programs uses few of the 132 SMs; here one block per (row, head,
//    256-key chunk) scores its chunk (8 lanes per key row, 16-byte loads),
//    takes a chunk-local softmax and writes (m, l, p@v); only keys below
//    the valid bound are read. attn_combine_kernel merges the chunks of a
//    (row, head) into o, which the wo GEMV reads as its input. With
//    kv_group G a block serves up to 8 query rows of one KV row, so a shared
//    cross K/V chunk is read once per 8 rows, not G times (G x fewer bytes on
//    the decode's largest read up to 8 beams); int8 K/V halves those bytes
//    again. In fp32
//    fused_attn_beam the same block reads each key row through the
//    ancestry map.
//  * The TPU's head-expansion matrix M is a lane trick: here each block
//    reduces its own head directly.
//
// Numerics follow the Pallas kernels: LN statistics in fp32 and LN(x) cast to
// the activation dtype before the products; q arrives in fp32 and is cast to
// the K dtype before q.k; softmax state in fp32, p cast to the V dtype for
// p@v; o cast to x's dtype before @wo; products accumulate in fp32; bias and
// residual are added in fp32, then cast. GELU uses erff (the Pallas kernel
// needed an erf polynomial because Mosaic has none).
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
// the launch is made (gemv, attn_partial, attn_combine, mlp_fc1, mlp_fc2,
// attn_q, attn_chunk, attn_wo, qkv): chip_smoke.py holds a decode step's
// counts to what its rows and layers imply
enum Kernel {
  K_GEMV = 0, K_PARTIAL = 1, K_COMBINE = 2, K_MLP1 = 3, K_MLP2 = 4,
  K_ATTN_Q = 5, K_CHUNK = 6, K_ATTN_WO = 7, K_QKV = 8, N_KERNELS = 9
};
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
  const long long* pos;  // self mode's position on the card: n_valid = *pos + 1, else null
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
  const int n_valid = a.pos != nullptr ? (int)min(max(*a.pos + 1, 1LL), (long long)a.T_len)
                                       : a.n_valid;
  const int t0 = s * CHUNK;
  const int t1 = min(t0 + CHUNK, n_valid);
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
                   int beam, const long long* pos = nullptr) {
  AttnArgs a{};
  a.pos = pos;
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

// ---------------------------------------------------------------------------
// The products of a pass on the tensor cores: bf16 fused_mlp's fc1 and fc2,
// and bf16 fused_attn's cross q and wo (the header's design notes)
// ---------------------------------------------------------------------------

constexpr int MLP_TILE = 64;                 // output columns a block: wgmma's M
constexpr int MLP_KS = 128;                  // weight rows (k) a ring stage
constexpr int MLP_MAX_ROWS = 32;             // decode rows a pass: wgmma's N, padded to 8/16/32
constexpr int MLP_CONSUMERS = 128;           // one warpgroup runs the products
constexpr int MLP_THREADS = MLP_CONSUMERS + 32;   // and one warp issues the loads
constexpr int MLP_MAX_D = 1280;              // fc1 and q stage x's rows whole: d <= 1280
constexpr int LN_CH = MLP_MAX_D / 256;       // 8-element chunks of a row a lane holds
constexpr int MLP_FIRST = 2;                 // stages issued before x's loads (LN kinds)
constexpr int MLP_COUNTERS = 1024;           // split-K tickets of one kernel (tiles <= 1024)
constexpr int QKV_STAGES = 5;                // bf16 qkv ring: a block's 5 steps (d 1280 split 2)
constexpr int SMEM_OPTIN = 227 * 1024;       // dynamic shared memory a block may take

// What a product kernel computes: out (B, N) = epilogue(act (B, K) @ W[layer] (K, N)).
//   P_FC1  act = LN(x) rounded to bf16;  GELU(v s + b1) into g (bf16)
//   P_FC2  act = g;                      (v s + b2) + x into out (bf16)
//   P_Q    act = LN(x) rounded to bf16;  (v s + bq) * 64^-0.5 into q (fp32)
//   P_WO   act = o, the attention core's output; (v s + bo) + x (fc2's)
//   P_QKV  act = LN(x) rounded to bf16;  by role: q as P_Q's; k = v s and
//          v = v s + bv in bf16, at a row stride of out_ld (the cache's)
enum ProdKind { P_FC1 = 0, P_FC2 = 1, P_Q = 2, P_WO = 3, P_QKV = 4 };
template <int KIND>
__host__ __device__ constexpr bool ln_kind() {
  return KIND == P_FC1 || KIND == P_Q || KIND == P_QKV;
}

// The weight ring: bf16 stages land 128-byte swizzled, wgmma's MN-major A
// as they are; int8 stages land unswizzled, 64 bytes a row, and are widened
// (exactly) into one of WIDE swizzled bf16 tiles before the products (wgmma
// cannot transpose int8). bf16 rings are deep enough to hold a block's whole
// weight tile at large-v3 and up to 16 rows (fc1: 10 stages, 160 KB, fewer
// beside 32 rows' activations; fc2: 7 stages; q and wo, d x d split six
// ways: 3; qkv, d x d split two ways: 5), so that it all streams while the
// block waits for and stages its activations.
template <typename WT, int NP, int KIND>
struct ProdCfg {
  static constexpr int BYTES = MLP_KS * 128;
  static constexpr int FIT1 = (192 * 1024 - NP * MLP_MAX_D * 2) / BYTES;   // beside fc1's act
  static constexpr int STAGES = KIND == P_FC1   ? (FIT1 < 10 ? FIT1 : 10)
                                : KIND == P_FC2 ? 7
                                : KIND == P_QKV ? QKV_STAGES
                                                : 3;
  static constexpr int WIDE = 0;
};
template <int NP, int KIND>
struct ProdCfg<int8_t, NP, KIND> {
  static constexpr int BYTES = MLP_KS * 64, STAGES = 5, WIDE = 3;
};
// Shared memory: the ring, the widened tiles, the swizzled activations
// (LN kinds: LN(x) of the whole rows; fc2 and wo: g or o over the block's
// k range), the barriers and a flag.
template <typename WT, int NP, int KIND>
constexpr int prod_smem(int act_bytes) {
  using C = ProdCfg<WT, NP, KIND>;
  return 1024 + C::STAGES * C::BYTES + C::WIDE * MLP_KS * 128 + act_bytes + 16 * C::STAGES + 16;
}

// a record of the attention core's partials per (row, head, chunk): acc[64],
// m, l and two floats of padding (16-byte rows)
constexpr int PART = HD + 4;

// One product of a pass. Block (tile, split) owns output columns tile*64 ..
// +63 and the ring steps [split*steps/splits, (split+1)*steps/splits) of K.
struct ProdArgs {
  const __nv_bfloat16* x;       // LN kinds: (B, K) the rows normalised; fc2/wo: the residual (B, N)
  const float* ln_s;            // LN kinds: (K,) fp32
  const float* ln_b;
  const __nv_bfloat16* act;     // fc2: g (B, K); wo: o (B, K)
  const __nv_bfloat16* bias;    // (N,), or null (qkv's k)
  const float* w_scale;         // (N,) fp32 of an int8 W, else null
  void* out;                    // (B, N): fp32 for q, else bf16
  float* sums;                  // splits > 1: (tiles, splits, NP/2, 128) fp32 partial sums
  int* counters;                // splits > 1: (tiles,) tickets, 0 between calls
  int B, K, N, layer, splits, steps;
  long long out_ld;             // qkv: elements from one row of out to the next
  int role;                     // qkv: 0 q, 1 k, 2 v
  int x_row0;                   // qkv: the pass's first row of x (its TMA coordinate)
  // qkv, the position on the card: k and v go to row *pos of out (a self
  // cache's, out at row 0), and nowhere when *pos lies outside [0, pos_limit)
  const long long* pos;
  int pos_limit;
};

// Timing probe of the MLP kernels, built only with -DMLP_TRACE
// (tools/bench_fused_mlp.py --trace): thread 0 of each block records the
// globaltimer at entry and exit (slots 0, 1) and clock64 at entry, after
// griddepcontrol.wait, after the prologue, after the products and at exit
// (slots 2, 3, 4, 5, 6).
#ifdef MLP_TRACE
__device__ unsigned long long g_mlp_trace[2][1024][8];
#define MLP_STAMP(i)                                                                   \
  if (KIND <= P_FC2 && threadIdx.x == 0) {                                             \
    unsigned long long* tr = g_mlp_trace[KIND & 1][blockIdx.y * gridDim.x + blockIdx.x]; \
    tr[2 + (i)] = clock64();                                                           \
    if ((i) == 0 || (i) == 4) {                                                        \
      unsigned long long gt;                                                           \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));                           \
      tr[(i) == 0 ? 0 : 1] = gt;                                                       \
    }                                                                                  \
  }
#else
#define MLP_STAMP(i)
#endif

// Timing probe of bf16 fused_attn's kernels, built only with -DATTN_TRACE
// (tools/bench_fused_attn.py --trace): thread 0 of each block of attn_q
// (kind 0), attn_chunk (1) and attn_wo (2) records the globaltimer at entry
// (slot 0), after griddepcontrol.wait (1), with its operands in shared
// memory (2: the activations; the core's K chunk) and at exit (3).
#ifdef ATTN_TRACE
__device__ unsigned long long g_attn_trace[3][4096][4];
__device__ __forceinline__ void attn_stamp(int kind, int slot) {
  if (threadIdx.x != 0) return;
  unsigned long long gt;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));
  const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (b < 4096) g_attn_trace[kind][b][slot] = gt;
}
#define ATTN_STAMP(kind, slot) attn_stamp(kind, slot)
#else
#define ATTN_STAMP(kind, slot)
#endif
// qkv's inner phases, in the core's slots (no core runs in a qkv-only
// timing): x landed (0), LN(x) done (1), the products done (2), the split
// sums added (3, a tile's last block)
#define QKV_STAMP(slot) \
  if (KIND == P_QKV) ATTN_STAMP(1, slot)

// both probes at a product kernel's points
#define PROD_STAMP(mlp_slot, attn_slot) \
  MLP_STAMP(mlp_slot);                   \
  if (KIND != P_FC1 && KIND != P_FC2) ATTN_STAMP(KIND == P_WO ? 2 : 0, attn_slot)

__device__ __forceinline__ void mlp_mma(float (&d)[4], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_bf16_n8<1, 0>(d, a, b, acc);
}
__device__ __forceinline__ void mlp_mma(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_bf16_n16<1, 0>(d, a, b, acc);
}
__device__ __forceinline__ void mlp_mma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_bf16_n32<1, 0>(d, a, b, acc);
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bytes 0..3 of an int8 word -> two bf16 pairs, exactly (|w| <= 127), on the
// ALU (the int -> float and float -> bf16 conversions run at a quarter
// rate): byte v + 128 as the mantissa of 2^23 gives 2^23 + 128 + v, less
// 2^23 + 128 is v, and a float holding a small integer is its bf16 in the
// upper half
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// An int8 stage (KS rows of 64 bytes, as TMA landed it) into a 128-byte
// swizzled bf16 tile of KS rows x 64 values: 16 bytes in, 32 out a step.
__device__ __forceinline__ void widen_stage(const uint8_t* src, uint8_t* dst) {
#pragma unroll
  for (int u = 0; u < MLP_KS * 4 / MLP_CONSUMERS; ++u) {
    const int c = threadIdx.x + u * MLP_CONSUMERS, r = c >> 2, q = c & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(src + c * 16);
    const uint2 a = widen4(v.x), b = widen4(v.y), cc = widen4(v.z), d = widen4(v.w);
    *reinterpret_cast<uint4*>(dst + sw128(r, q * 32)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(dst + sw128(r, q * 32 + 16)) = make_uint4(cc.x, cc.y, d.x, d.y);
  }
}

// the address of 16-byte chunk kc (8 bf16 from k = 8 kc) of row b in the
// activation tiles: 64 k a tile of NP rows x 128 bytes, swizzled
template <int NP>
__device__ __forceinline__ uint8_t* act_chunk(uint8_t* act, int b, int kc) {
  return act + (kc >> 3) * (NP * 128) + sw128(b, (kc & 7) * 16);
}

// Block (tile, blockIdx.y) of a product: tile is blockIdx.x, or for qkv the
// column tile within the block's projection
template <typename WT, int NP, int KIND>
__device__ __forceinline__ void prod_body(const CUtensorMap* wmap, const ProdArgs& a, int tile,
                                          const CUtensorMap* xmap = nullptr) {
  using C = ProdCfg<WT, NP, KIND>;
  constexpr bool LN = ln_kind<KIND>();
  constexpr int ACC = NP / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* wide = ring + C::STAGES * C::BYTES;
  uint8_t* act = wide + C::WIDE * MLP_KS * 128;
  const int split = blockIdx.y, S = a.splits;
  const int s0 = split * a.steps / S, nst = (split + 1) * a.steps / S - s0;
  const int k0 = s0 * MLP_KS, k1 = min((s0 + nst) * MLP_KS, a.K);
  const int kt = LN ? 0 : k0;   // k of the activation tiles' first column
  // 16-byte chunks of a tile row: LN kinds all of K, fc2 and wo the block's range
  const int R8 = (LN ? a.steps : nst) * MLP_KS / 8;
  uint64_t* full = reinterpret_cast<uint64_t*>(act + R8 / 8 * (NP * 128));
  uint64_t* empty = full + C::STAGES;
  volatile int* last = reinterpret_cast<volatile int*>(empty + C::STAGES);
  // qkv loads x by TMA boxes of 64 columns x NP rows that land 128-byte
  // swizzled, as the tiles are (at 32 rows 6.0 -> ~1 us to x in shared
  // memory against 5,120 cp.async a block, 120 blocks at the same lines)
  constexpr bool TMA_X = KIND == P_QKV;
  uint64_t* xbar = empty + C::STAGES + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = threadIdx.x;
  const int n0 = tile * MLP_TILE;
  PROD_STAMP(0, 0);

  if (t == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MLP_CONSUMERS / 32);
    }
    if constexpr (TMA_X) mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // epilogue items of this thread: accumulator r holds output column
  // n0 + 16 w + g + 8 h, row 8 j + 2 q + e (r = 4 j + 2 h + e)
  auto item_row = [&](int r) { return 8 * (r >> 2) + 2 * (t & 3) + (r & 1); };
  auto item_col = [&](int r) { return n0 + 16 * warp + ((t & 31) >> 2) + 8 * ((r >> 1) & 1); };
  auto mine = [&](int r) { return item_row(r) < a.B; };

  float acc[ACC], e_scale[ACC], e_bias[ACC], e_x[ACC];
  auto epilogue = [&]() {
    long long row_off = 0;   // qkv's k and v at the position on the card
    if (KIND == P_QKV && a.role != 0 && a.pos != nullptr) {
      const long long p = *a.pos;
      if (p < 0 || p >= a.pos_limit) return;
      row_off = p * a.N;
    }
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      if (mine(r)) {
        float v = acc[r];
        if (a.w_scale != nullptr) v = __fmul_rn(v, e_scale[r]);   // the int8 scale, after the sum
        if (KIND != P_QKV || a.bias != nullptr) v = __fadd_rn(v, e_bias[r]);
        const long long ld = KIND == P_QKV ? a.out_ld : (long long)a.N;
        const long long o = (long long)item_row(r) * ld + item_col(r) + row_off;
        if (KIND == P_Q || (KIND == P_QKV && a.role == 0)) {
          static_cast<float*>(a.out)[o] = __fmul_rn(v, 0.125f);   // 64^-0.5
        } else {
          if constexpr (KIND == P_FC1) {
            v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          } else if constexpr (KIND == P_FC2 || KIND == P_WO) {
            v = __fadd_rn(v, e_x[r]);
          }
          static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
        }
      }
    }
  };
  if (warp == MLP_CONSUMERS / 32) {
    // the producer: the weights depend on no kernel before this one, so
    // they stream from the start (LN kinds: the first stages only, then x's
    // loads, which would otherwise queue behind the weights)
    const int first = LN ? min(MLP_FIRST, nst) : 0;
    if (lane == 0) {
      for (int i = 0; i < first; ++i) {
        mbar_arrive_expect_tx(&full[i], C::BYTES);
        tma_load_3d(ring + i * C::BYTES, wmap, &full[i], n0, (s0 + i) * MLP_KS, a.layer);
      }
    }
    __syncwarp();
    if constexpr (LN) named_barrier(2, MLP_THREADS);
    if (lane == 0) {
      for (int i = first; i < nst; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(&empty[s], (i / C::STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], C::BYTES);
        tma_load_3d(ring + s * C::BYTES, wmap, &full[s], n0, (s0 + i) * MLP_KS, a.layer);
      }
    }
    __syncwarp();
    MLP_STAMP(4);
    return;
  }
  {
    // the next kernel may start: fc2 streams W2 while fc1 runs; the
    // attention core loads its cross K/V while q is computed (after qkv,
    // the self core waits before its K/V: qkv writes their row pos)
    if constexpr (LN) griddep_launch();
    // the operands no kernel before writes, the layer's parameters: the
    // weights' scale and bias, LN's. qkv loads them before its wait (at 4
    // rows 8.3 -> 6.5 us a call: their round trip leaves the critical path)
    constexpr bool EARLY = KIND == P_QKV;
    float ls[LN_CH][8], lb[LN_CH][8];
    auto params = [&]() {
#pragma unroll
      for (int r = 0; r < ACC; ++r) {
        e_scale[r] = e_bias[r] = e_x[r] = 0.f;
        if (mine(r)) {
          const int col = item_col(r);
          e_scale[r] = a.w_scale != nullptr ? a.w_scale[col] : 1.f;
          e_bias[r] = KIND != P_QKV || a.bias != nullptr ? to_f(a.bias[col]) : 0.f;
        }
      }
      if constexpr (LN) {   // each lane's LN scale and bias, the same for every row
#pragma unroll
        for (int i = 0; i < LN_CH; ++i) {
          const int k = (lane + 32 * i) * 8;
          if (k < a.K) {
            load8(a.ln_s + k, ls[i]);
            load8(a.ln_b + k, lb[i]);
          }
        }
      }
    };
    if constexpr (EARLY) params();
    griddep_wait();              // x, g and o are written by the kernels before
    PROD_STAMP(1, 1);
    // the activations: LN kinds x's whole rows into the tiles, to be
    // normalised in place; fc2 and wo g's or o's k range. Rows >= B and k
    // >= K are zeros. qkv's by TMA, issued ahead of the rest of the weight
    // stream; the others through cp.async (the load/store unit, not the
    // busy TMA unit)
    if constexpr (TMA_X) {
      if (t == 0) {
        mbar_arrive_expect_tx(xbar, R8 / 8 * NP * 128);
        for (int j = 0; j < R8 / 8; ++j)
          tma_load_3d(act + j * (NP * 128), xmap, xbar, j * 64, a.x_row0, 0);
      }
    } else {
      for (int c = t; c < NP * R8; c += MLP_CONSUMERS) {
        const int b = c / R8, kc = c - b * R8, k = kt + kc * 8;
        uint8_t* dst = act_chunk<NP>(act, b, kc);
        if (b < a.B && k < (LN ? a.K : k1)) {
          cp_async16(dst, (LN ? a.x : a.act) + (long long)b * a.K + k);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    if constexpr (LN) named_barrier_arrive(2, MLP_THREADS);   // the producer may go on
    // the epilogue's operands meanwhile
    if constexpr (!EARLY) params();
    if constexpr (!LN) {
#pragma unroll
      for (int r = 0; r < ACC; ++r)
        if (mine(r)) e_x[r] = to_f(a.x[(long long)item_row(r) * a.N + item_col(r)]);
    }
    if constexpr (LN) {
      if constexpr (TMA_X) {
        mbar_wait(xbar, 0);
      } else {
        cp_async_wait_all();
        named_barrier(1, MLP_CONSUMERS);
      }
      QKV_STAMP(0);
      // LN in place, a warp a row, in the plain version's operations: the
      // mean and the variance about it as fp32 sums times fp32(1 / d) (the
      // sums taken in fp64 and rounded once, the likeliest bits of any fp32
      // sum), then ((x - mean) * rstd) * scale + bias, each step rounded
      // alone (no FMA). A last bit apart here flips LN(x)'s bf16 rounding
      // now and then, and one flip moves all of the product's outputs on
      // its row.
      const float inv_k = 1.f / a.K;
      for (int b = warp; b < a.B; b += MLP_CONSUMERS / 32) {
        float v[LN_CH][8];
        double sum = 0.0;
#pragma unroll
        for (int i = 0; i < LN_CH; ++i) {
          if ((lane + 32 * i) * 8 < a.K) {
            load8(reinterpret_cast<const __nv_bfloat16*>(act_chunk<NP>(act, b, lane + 32 * i)),
                  v[i]);
#pragma unroll
            for (int e = 0; e < 8; ++e) sum += v[i][e];
          }
        }
        const float mean = __fmul_rn(static_cast<float>(warp_sum_f64(sum)), inv_k);
        double ss = 0.0;
#pragma unroll
        for (int i = 0; i < LN_CH; ++i) {
          if ((lane + 32 * i) * 8 < a.K) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float dv = __fsub_rn(v[i][e], mean);
              ss += __fmul_rn(dv, dv);
            }
          }
        }
        const float var = __fmul_rn(static_cast<float>(warp_sum_f64(ss)), inv_k);
        const float rstd = rsqrtf(__fadd_rn(var, 1e-5f));
#pragma unroll
        for (int i = 0; i < LN_CH; ++i) {
          if ((lane + 32 * i) * 8 < a.K) {
            float h[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              h[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i][e], mean), rstd), ls[i][e]),
                               lb[i][e]);
            *reinterpret_cast<uint4*>(act_chunk<NP>(act, b, lane + 32 * i)) =
                make_uint4(bf16x2(h[0], h[1]), bf16x2(h[2], h[3]), bf16x2(h[4], h[5]),
                           bf16x2(h[6], h[7]));
          }
        }
      }
    } else {
      cp_async_wait_all();
    }
    QKV_STAMP(1);
    fence_proxy_async();
    named_barrier(1, MLP_CONSUMERS);
    PROD_STAMP(2, 2);

    // the products. The tensor cores add a wgmma's products to its
    // accumulator with truncation, not an fp32 add's rounding: summed there
    // over all of K, fc1's error flipped g's bf16 rounding more often than
    // the plain version's fp32 product does, by enough to cross the
    // contract's tolerance. So each pair of a stage's k16 steps sums into a
    // fresh accumulator (32 products), which the CUDA cores add to acc in
    // fp32, in k order.
    constexpr int PAIRS = MLP_KS / 32;
    float pair[PAIRS][ACC];
#pragma unroll
    for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
    for (int i = 0; i < nst; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint8_t* A = ring + s * C::BYTES;
      if constexpr (C::WIDE > 0) {
        // the tile widened at step i - WIDE is free: every warp passed its
        // wgmma_wait<0> of step i - 2 before the barrier of step i - 1
        uint8_t* wt = wide + (i % C::WIDE) * (MLP_KS * 128);
        widen_stage(A, wt);
        fence_proxy_async();
        named_barrier(1, MLP_CONSUMERS);
        if (lane == 0) mbar_arrive(&empty[s]);
        A = wt;
      }
#pragma unroll
      for (int pp = 0; pp < PAIRS; ++pp) fence_regs(pair[pp]);
      wgmma_fence();
      const int kb = k0 - kt + i * MLP_KS;   // the stage's first k within the tiles
#pragma unroll
      for (int kk = 0; kk < MLP_KS / 16; ++kk) {
        const int kl = kb + kk * 16;
        mlp_mma(pair[kk >> 1], sw128_desc(A + kk * 2048),
                sw128_desc(act + (kl >> 6) * (NP * 128) + (kl & 63) * 2), kk & 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int pp = 0; pp < PAIRS; ++pp) fence_regs(pair[pp]);
      if (C::WIDE == 0 && lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int pp = 0; pp < PAIRS; ++pp)
#pragma unroll
        for (int r = 0; r < ACC; ++r) acc[r] += pair[pp][r];
    }
    MLP_STAMP(3);
    QKV_STAMP(2);

    if (S > 1) {
      // split K: every block writes its partial sums; the last of a tile's
      // blocks to take a ticket adds them in split order (the same bits
      // whichever block that is) and resets the ticket for the next call.
      // The ticket's release / acquire orders the sums (no fences).
      float* own = a.sums + (long long)(tile * S + split) * ACC * MLP_CONSUMERS + t;
#pragma unroll
      for (int r = 0; r < ACC; ++r) own[r * MLP_CONSUMERS] = acc[r];
      named_barrier(1, MLP_CONSUMERS);
      if (t == 0) *last = ticket(&a.counters[tile]) == S - 1;
      named_barrier(1, MLP_CONSUMERS);
      if (!*last) {
        PROD_STAMP(4, 3);
        return;
      }
      const float* all = a.sums + (long long)tile * S * ACC * MLP_CONSUMERS + t;
#pragma unroll
      for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
      for (int s4 = 0; s4 < S; s4 += 4) {   // 4 splits' loads in flight at once
        float p[4][ACC];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < ACC; ++r)
            p[u][r] = s4 + u < S ? __ldcg(all + ((s4 + u) * ACC + r) * MLP_CONSUMERS) : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r = 0; r < ACC; ++r)
            if (s4 + u < S) acc[r] += p[u][r];
      }
      if (t == 0) a.counters[tile] = 0;
      QKV_STAMP(3);
    }
    epilogue();
  }
  PROD_STAMP(4, 3);
}

template <typename WT, int NP>
__global__ void __launch_bounds__(MLP_THREADS, 1)
mlp_fc1_kernel(const __grid_constant__ CUtensorMap wmap, const ProdArgs a) {
  prod_body<WT, NP, P_FC1>(&wmap, a, blockIdx.x);
}

template <typename WT, int NP>
__global__ void __launch_bounds__(MLP_THREADS, 1)
mlp_fc2_kernel(const __grid_constant__ CUtensorMap wmap, const ProdArgs a) {
  prod_body<WT, NP, P_FC2>(&wmap, a, blockIdx.x);
}

template <typename WT, int NP>
__global__ void __launch_bounds__(MLP_THREADS, 1)
attn_q_kernel(const __grid_constant__ CUtensorMap wmap, const ProdArgs a) {
  prod_body<WT, NP, P_Q>(&wmap, a, blockIdx.x);
}

template <typename WT, int NP>
__global__ void __launch_bounds__(MLP_THREADS, 1)
attn_wo_kernel(const __grid_constant__ CUtensorMap wmap, const ProdArgs a) {
  prod_body<WT, NP, P_WO>(&wmap, a, blockIdx.x);
}

// bf16 fused_qkv's three projections in one launch: the grid's tiles are
// q's, then k's, then v's; a block reads its projection's map and takes its
// weight type (bit p of w8: projection p is int8), uniform within the block
struct QkvArgs {
  ProdArgs p[3];
  int w8;
};

template <int NP>
__global__ void __launch_bounds__(MLP_THREADS, 1)
qkv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mx,
           const QkvArgs a) {
  const int tiles = a.p[0].N / MLP_TILE;
  const int proj = blockIdx.x / tiles, tile = blockIdx.x - proj * tiles;
  const CUtensorMap* map = proj == 0 ? &mq : proj == 1 ? &mk : &mv;
  // the block's arguments in registers (read in place through the run-time
  // index, every shared-memory store might alias them)
  const ProdArgs pa = a.p[proj];
  if ((a.w8 >> proj) & 1) {
    prod_body<int8_t, NP, P_QKV>(map, pa, tile, &mx);
  } else {
    prod_body<__nv_bfloat16, NP, P_QKV>(map, pa, tile, &mx);
  }
}

// ---------------------------------------------------------------------------
// bf16 fused_attn's attention core: one block per (KV row, head, chunk of
// ACH keys, up to 8 query rows of the KV row), its K and V chunk loaded
// whole by TMA at entry, scores and p.v from shared memory on the tensor
// cores
// ---------------------------------------------------------------------------

constexpr int ACH = 256;                     // keys a block (measured: 128 no faster)
constexpr int CORE_THREADS = ACH;
constexpr int CORE_WARPS = CORE_THREADS / 32;
constexpr int KV_BOX = 64;                   // keys a TMA box
constexpr int MAX_SPLIT = 32;                // chunks a (row, head): n_valid <= 32 ACH
constexpr int COMB_SCRATCH = 3 * MAX_SPLIT + 2;  // a row's combine floats: (m, l), w, L

// byte offset of byte `col` of row `row` in a 64-byte-swizzled tile (rows
// of 64 bytes, as TMA's CU_TENSOR_MAP_SWIZZLE_64B lands them: 16-byte chunk
// c of row r at c ^ ((r / 2) % 4))
__device__ __forceinline__ uint32_t sw64(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// D (16 x 8, fp32) += A (16 x 16, bf16 fragments) . B (16 x 8, bf16 fragments)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 values -> a bf16 pair, exactly
__device__ __forceinline__ uint32_t widen2(int8_t lo, int8_t hi) {
  return bf16x2(static_cast<float>(lo), static_cast<float>(hi));
}

// S's B fragment (K^T) of key row `key`: dims c, c + 1 and c + 8, c + 9
__device__ __forceinline__ void kfrag(const uint8_t* tile, int key, int c, uint32_t& b0,
                                      uint32_t& b1, __nv_bfloat16) {
  b0 = *reinterpret_cast<const uint32_t*>(tile + sw128(key, 2 * c));
  b1 = *reinterpret_cast<const uint32_t*>(tile + sw128(key, 2 * c + 16));
}
__device__ __forceinline__ void kfrag(const uint8_t* tile, int key, int c, uint32_t& b0,
                                      uint32_t& b1, int8_t) {
  const int8_t* lo = reinterpret_cast<const int8_t*>(tile + sw64(key, c));
  const int8_t* hi = reinterpret_cast<const int8_t*>(tile + sw64(key, c + 8));
  b0 = widen2(lo[0], lo[1]);
  b1 = widen2(hi[0], hi[1]);
}

// O's B fragments (V) of keys k0 .. k0 + 15 and dims d0 .. d0 + 15: b[0],
// b[1] of dims d0 .. d0 + 7, b[2], b[3] of dims d0 + 8 .. d0 + 15. bf16:
// ldmatrix.trans of four 8 x 8 tiles, lane i naming row i % 8 of tile i /
// 8; int8: each value gathered and widened
__device__ __forceinline__ void vfrag(const uint8_t* tile, int k0, int d0, int lane,
                                      uint32_t (&b)[4], __nv_bfloat16) {
  const int key = k0 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const uint8_t* p = tile + sw128(key, 2 * d0 + (lane >> 4) * 16);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void vfrag(const uint8_t* tile, int k0, int d0, int lane,
                                      uint32_t (&b)[4], int8_t) {
  const int g = lane >> 2, qd = lane & 3;
  auto at = [&](int key, int dim) {
    return *reinterpret_cast<const int8_t*>(tile + sw64(key, dim));
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // (dims, keys) halves: (0, 0), (0, 8), (8, 0), (8, 8)
    const int key = k0 + 2 * qd + (i & 1) * 8, dim = d0 + (i >> 1) * 8 + g;
    b[i] = widen2(at(key, dim), at(key + 1, dim));
  }
}

// What the attention core reads. The pass's query rows r0 .. r0 + n come in
// groups of Gp rows that share a KV row: group z holds rows r0 + z Gp ..,
// whose KV row is (r0 + z Gp) / G (kv_group G; Gp = G, or the pass's n
// rows of one wider group). A block serves gs = min(Gp, 8) rows of a group,
// so a group takes n_sub = ceil(Gp / gs) blocks, the last maybe fewer rows.
struct CoreArgs {
  const float* q;        // (N, d) fp32, pre-scaled by 64^-0.5
  const float* k_scale;  // int8 K/V: (N / G, d) fp32 per-(row, head) scales at the layer, else null
  const float* v_scale;  // the same of V, else null
  float* part;           // n_split > 1: (N, d/64, n_split, PART) partials
  int* counters;         // n_split > 1: (blocks of rows x d/64) tickets, 0 between calls
  __nv_bfloat16* o;      // (N, d): the attention's output, wo's input
  int d, n_valid, n_split, r0, Gp, gs, n_sub, G;
  int kv_row0;           // the TMA row of KV row 0 of the layer (layer x KV rows)
  int kv_early;          // the K/V predate the kernel before: load them before its wait
  // beam mode (anc non-null; bf16, one query row a block): query row r
  // reads key t from cache row (r - r % beam) + anc[r, t] of the layer,
  // gathered a key row at a time from the stacked (L x N, T_len, d) bases
  const int* anc;        // (N, T_len) int32 ancestry
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  int beam, T_len;
  // self mode, the position on the card: n_valid = *pos + 1 (held to [1,
  // T_len]), n_split the cache's ceil(T_len / ACH) chunks, of which those at
  // or past n_valid only take their ticket
  const long long* pos;
};

template <typename KV, int MAXG>
constexpr int core_smem() {
  return 1024 + 2 * ACH * HD * (int)sizeof(KV) + MAXG * HD * 4 + MAXG * COMB_SCRATCH * 4 +
         CORE_WARPS * MAXG * 4 + 16;
}

// Beam mode's loads: query row r's keys t0 .. t0 + nk - 1 of head h, each
// key row's 128 bytes of K and of V from cache row (r - r % beam) + anc[r,
// t] of the layer, by cp.async, 16 bytes a thread, into the 128-byte
// swizzled tiles the TMA boxes land (so the scores and p.v read them
// unchanged). Every thread's K copies complete on bar[0] and then its V
// copies on bar[1] (a no-increment arrival each: the barriers count
// CORE_THREADS), so the scores start while V lands. Keys past nk up to the
// last live warp's 32 are zeros, where a box would have loaded cache rows:
// p is 0 there, and 0 x a stale bit pattern could be NaN. The caller
// issues this after griddepcontrol.wait: fused_qkv, the kernel before,
// writes the newest key (row pos) into the cache; the ancestry, which
// addresses every copy, loads with them.
__device__ __forceinline__ void gather_kv(const CoreArgs& a, uint8_t* ks, uint8_t* vs,
                                          uint64_t* bar, int r, int h, int t0, int nk) {
  constexpr int PIECES = HD * 2 / 16;                        // 16-byte pieces a key row
  constexpr int PER = ACH * PIECES / CORE_THREADS;           // pieces a thread, K or V
  const int tid = threadIdx.x;
  const int* anc = a.anc + (long long)r * a.T_len + t0;
  const long long row0 = (long long)a.kv_row0 + (r - r % a.beam);
  const int nz = min(ACH, (nk + 31) / 32 * 32);              // keys the live warps read
  long long off[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * CORE_THREADS, key = i / PIECES, c = i % PIECES;
    off[u] = -1;
    if (key < nk) {
      off[u] = ((row0 + anc[key]) * a.T_len + t0 + key) * a.d + h * HD + c * 8;
      cp_async16(ks + sw128(key, c * 16), a.kb + off[u]);
    } else if (key < nz) {
      *reinterpret_cast<uint4*>(ks + sw128(key, c * 16)) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vs + sw128(key, c * 16)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_arrive_noinc(&bar[0]);
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid + u * CORE_THREADS, key = i / PIECES, c = i % PIECES;
    if (off[u] >= 0) cp_async16(vs + sw128(key, c * 16), a.vb + off[u]);
  }
  cp_async_arrive_noinc(&bar[1]);
}

// The tail of a (rows, head)'s chunks when there are several: each chunk's
// block takes a ticket once its partials, if it has valid keys, are written;
// the last to take one combines those of the first ceil(n_valid / ACH)
// chunks in chunk order (attn_combine_kernel's), o[r, h*64 + j] = A_j [x
// v_scale] / L cast to bf16, and resets the ticket. scr holds MAXG rows of
// COMB_SCRATCH floats.
template <int MAXG>
__device__ __forceinline__ void combine_chunks(const CoreArgs& a, float* scr, int r0, int G, int h,
                                               int H, int kvr, int n_valid) {
  const int tid = threadIdx.x, ns = a.n_split, nv = (n_valid + ACH - 1) / ACH;
  __shared__ int last;
  int* counter = a.counters + blockIdx.z * H + h;
  if (tid == 0) last = ticket(counter) == ns - 1;
  __syncthreads();
  if (!last) return;
  auto rec = [&](int g, int c) {
    return a.part + ((long long)((r0 + g) * H + h) * ns + c) * PART;
  };
  // each row's chunks' (m, l) into shared memory, then their weights
  // w[g][c] = e^(m_c - M) and L[g]
  float2* ml = reinterpret_cast<float2*>(scr);   // [G][nv]
  float* Ls = scr + 2 * MAXG * MAX_SPLIT;        // [G]
  float* wts = Ls + MAXG;                        // [G][nv]
  for (int i = tid; i < G * nv; i += CORE_THREADS)
    ml[i] = __ldcg(reinterpret_cast<const float2*>(rec(i / nv, i % nv) + HD));
  __syncthreads();
  if (tid < G) {
    float M = NEG, L = 0.f;
    for (int c = 0; c < nv; ++c) M = fmaxf(M, ml[tid * nv + c].x);
    for (int c = 0; c < nv; ++c) {
      const float2 v = ml[tid * nv + c];
      const float wc = expf(v.x - M);
      L += v.y * wc;
      wts[tid * nv + c] = wc;
    }
    Ls[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += CORE_THREADS) {
    const int g = i / HD, j = i - g * HD;
    const float* w = wts + g * nv;
    float A = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < MAX_SPLIT; c0 += 8) {   // 8 chunks' loads in flight at once
      if (c0 >= nv) break;
      float u[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) u[c] = c0 + c < nv ? __ldcg(rec(g, c0 + c) + j) : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < nv) A += u[c] * w[c0 + c];
    }
    if (a.v_scale != nullptr) A *= a.v_scale[(long long)kvr * a.d + h * HD + j];
    a.o[(long long)(r0 + g) * a.d + h * HD + j] = __float2bfloat16(A / Ls[g]);
  }
  if (tid == 0) *counter = 0;
}

// Chunk-local softmax of the block's query rows (the split-T flash-decoding
// of the header): (acc[64] = sum_t p_t v_t, m, l = sum_t p_t) over the
// chunk's keys t < n_valid, p_t = e^(s_t - m) rounded to bf16 for p.v, l
// summed in fp32. Thread 0 issues the chunk's K and V as 64-key TMA boxes
// at entry (only boxes holding valid keys), K's and V's on barriers of their
// own, so the scores start as soon as K is in and V lands meanwhile; in
// cross mode (kv_early) before the wait for the kernel before, which writes
// q. q is rounded to bf16 after K's scale, as the Pallas kernel's q * ksc
// (:237-243). The warps' p.v are summed through shared memory over the K
// tile, which is dead by then. int8 K/V widen exactly; V's scale multiplies
// the combined accumulator. A chunk then combines into o, or writes its
// partials and the last chunk of its (rows, head) combines them (the
// tail). Beam mode (a.anc, bf16, one query row a block) takes the chunk's
// key rows from the cache rows the ancestry names instead of whole boxes:
// gather_kv.
template <typename KV, int MAXG>
__global__ void __launch_bounds__(CORE_THREADS)
attn_chunk_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const CoreArgs a) {
  constexpr int RB = HD * (int)sizeof(KV);   // bytes of a key row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + ACH * RB;
  float* q_s = reinterpret_cast<float*>(vs + ACH * RB);   // [MAXG][64]
  float* scr = q_s + MAXG * HD;                           // [MAXG][COMB_SCRATCH]
  float (*red)[MAXG] = reinterpret_cast<float (*)[MAXG]>(scr + MAXG * COMB_SCRATCH);
  uint64_t* bar = reinterpret_cast<uint64_t*>(scr + MAXG * COMB_SCRATCH + CORE_WARPS * MAXG);
  float* acc_s = reinterpret_cast<float*>(ks);            // [CORE_WARPS][MAXG][64], over K

  const int s = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int grp = blockIdx.z / a.n_sub, sub = blockIdx.z % a.n_sub;
  const int G = min(a.gs, a.Gp - sub * a.gs);            // this block's rows
  const int r0 = a.r0 + grp * a.Gp + sub * a.gs;         // its first query row
  const int kvr = (a.r0 + grp * a.Gp) / a.G;             // their KV row
  const int n_valid = a.pos != nullptr ? (int)min(max(*a.pos + 1, 1LL), (long long)a.T_len)
                                       : a.n_valid;
  const int t0 = s * ACH, nk = min(ACH, n_valid - t0);   // valid keys of the chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  ATTN_STAMP(1, 0);
  if (nk <= 0) {   // a chunk past the valid keys: no partial, only its ticket
    griddep_launch();
    griddep_wait();
    combine_chunks<MAXG>(a, scr, r0, G, h, H, kvr, n_valid);
    ATTN_STAMP(1, 3);
    return;
  }

  if (tid == 0) {   // a gather's barriers take every thread's arrival
    mbar_init(&bar[0], a.anc != nullptr ? CORE_THREADS : 1);
    mbar_init(&bar[1], a.anc != nullptr ? CORE_THREADS : 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&]() {
    if constexpr (std::is_same<KV, __nv_bfloat16>::value && MAXG == 1) {   // beam mode's instance
      if (a.anc != nullptr) {
        gather_kv(a, ks, vs, bar, r0, h, t0, nk);
        return;
      }
    }
    if (tid == 0) {
      const int boxes = (nk + KV_BOX - 1) / KV_BOX;
      mbar_arrive_expect_tx(&bar[0], boxes * KV_BOX * RB);
      mbar_arrive_expect_tx(&bar[1], boxes * KV_BOX * RB);
      for (int i = 0; i < boxes; ++i)
        tma_load_3d(ks + i * KV_BOX * RB, &kmap, &bar[0], h * HD, t0 + i * KV_BOX,
                    a.kv_row0 + kvr);
      for (int i = 0; i < boxes; ++i)
        tma_load_3d(vs + i * KV_BOX * RB, &vmap, &bar[1], h * HD, t0 + i * KV_BOX,
                    a.kv_row0 + kvr);
    }
  };
  if (a.kv_early) issue();
  griddep_launch();   // the wo kernel may start streaming wo
  // q (and a self cache's newest key) are written by the kernels before:
  // self and beam mode issue their K/V after this wait
  griddep_wait();
  ATTN_STAMP(1, 1);
  if (!a.kv_early) issue();

  for (int i = tid; i < G * HD; i += CORE_THREADS) {
    const int g = i / HD, c = i - g * HD;
    float qq = __ldcg(a.q + (long long)(r0 + g) * a.d + h * HD + c);
    if (a.k_scale != nullptr) qq *= a.k_scale[(long long)kvr * a.d + h * HD + c];
    q_s[i] = round_t<__nv_bfloat16>(qq);
  }
  __syncthreads();

  float* ml_s = q_s;   // (m, l) of each query row, over q once the scores are taken
  // the scores and p.v on the tensor cores (mma.sync m16n8k16, bf16 in,
  // fp32 out): warp w takes keys 32 w .. 32 w + 31 of the chunk. S = Q K^T
  // with the query rows as M (8 of 16 used) and the keys as N: each thread
  // then holds query row g = lane / 4's scores of keys 8 j + 2 (lane % 4)
  // + {0, 1}, which rounded to bf16 are P's A fragments for O = P V, V read
  // by ldmatrix.trans (int8: gathered and widened exactly). Each pair of
  // k16 steps sums into a fresh accumulator, added in fp32 (the tensor
  // cores truncate as they accumulate). A warp whose keys all lie past the
  // valid ones computes nothing: its V rows may not have been loaded.
  const int g = lane >> 2, qd = lane & 3, kw = warp * 32;
  const bool live = kw < nk, mine = g < G;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const float* qr = q_s + g * HD + 16 * k + 2 * qd;
    qa[k][0] = mine ? bf16x2(qr[0], qr[1]) : 0u;
    qa[k][2] = mine ? bf16x2(qr[8], qr[9]) : 0u;
    qa[k][1] = qa[k][3] = 0u;
  }
  float sc[4][2];
  mbar_wait(&bar[0], 0);
  ATTN_STAMP(1, 2);
  float mx = NEG;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const int key = kw + 8 * j + g;   // B's column: this lane's key
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        uint32_t b0, b1;
        kfrag(ks, key, 16 * k + 2 * qd, b0, b1, KV{});
        mma_bf16_16816(k < 2 ? d0 : d1, qa[k], b0, b1);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = live && kw + 8 * j + 2 * qd + e < nk;
      sc[j][e] = ok ? d0[e] + d1[e] : NEG;
      mx = fmaxf(mx, sc[j][e]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (qd == 0 && g < MAXG) red[warp][g] = mx;
  __syncthreads();
  float m = NEG;
  for (int w = 0; w < CORE_WARPS; ++w) m = fmaxf(m, g < MAXG ? red[w][g] : NEG);
  __syncthreads();
  float ls = 0.f;
  uint32_t pa[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float pe[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pe[e] = mine && sc[j][e] > NEG ? expf(sc[j][e] - m) : 0.f;
      ls += pe[e];                          // the sum takes p in fp32 ...
    }
    pa[j >> 1][(j & 1) * 2] = bf16x2(pe[0], pe[1]);   // ... p.v takes it in bf16
    pa[j >> 1][(j & 1) * 2 + 1] = 0u;
  }
  ls += __shfl_xor_sync(0xffffffffu, ls, 1);
  ls += __shfl_xor_sync(0xffffffffu, ls, 2);
  if (qd == 0 && g < MAXG) red[warp][g] = ls;
  __syncthreads();
  float l = 0.f;
  for (int w = 0; w < CORE_WARPS; ++w) l += g < MAXG ? red[w][g] : 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  mbar_wait(&bar[1], 0);
  if (live) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {   // two dim n-tiles a step
        uint32_t b[4];
        vfrag(vs, kw + 16 * k, 16 * n, lane, b, KV{});
        mma_bf16_16816(o[2 * n], pa[k], b[0], b[1]);
        mma_bf16_16816(o[2 * n + 1], pa[k], b[2], b[3]);
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(acc_s + (warp * MAXG + g) * HD + 8 * n + 2 * qd) =
          make_float2(o[n][0], o[n][1]);
    if (warp == 0 && qd == 0) {
      ml_s[2 * g] = m;
      ml_s[2 * g + 1] = l;
    }
  }
  __syncthreads();
  // o[r, h*64 + j] = A_j [x v_scale] / L cast to bf16, A and L over the
  // chunks in attn_combine_kernel's order (the header): one chunk is its
  // own combine (e^0 = 1); otherwise every block writes its partials and
  // the last of a (rows, head)'s chunks to take a ticket combines them all
  auto o_at = [&](int g, int j) { return a.o + (long long)(r0 + g) * a.d + h * HD + j; };
  auto vs_at = [&](int j) {
    return a.v_scale != nullptr ? a.v_scale[(long long)kvr * a.d + h * HD + j] : 1.f;
  };
  if (a.n_split == 1) {
    for (int i = tid; i < G * HD; i += CORE_THREADS) {
      const int g = i / HD, j = i - g * HD;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < CORE_WARPS; ++w) A += acc_s[(w * MAXG + g) * HD + j];
      if (a.v_scale != nullptr) A *= vs_at(j);
      *o_at(g, j) = __float2bfloat16(A / ml_s[2 * g + 1]);
    }
    ATTN_STAMP(1, 3);
    return;
  }
  const int ns = a.n_split;
  auto rec = [&](int g, int c) {
    return a.part + ((long long)((r0 + g) * H + h) * ns + c) * PART;
  };
  for (int i = tid; i < G * HD; i += CORE_THREADS) {
    const int g = i / HD, j = i - g * HD;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CORE_WARPS; ++w) sum += acc_s[(w * MAXG + g) * HD + j];
    rec(g, s)[j] = sum;
  }
  if (tid < 2 * G) rec(tid / 2, s)[HD + (tid & 1)] = ml_s[tid];
  __syncthreads();
  combine_chunks<MAXG>(a, scr, r0, G, h, H, kvr, n_valid);
  ATTN_STAMP(1, 3);
}

// ---------------------------------------------------------------------------
// host: tensor maps, launches
// ---------------------------------------------------------------------------

// A 3-D tensor map over a contiguous (dims[2], dims[1], dims[0]) tensor at
// base, boxes of box0 x box1 x 1, encoded once and kept (keyed by base,
// element size, shape and box; the strides follow from the shape), so a
// decode step encodes nothing: the stacked (L, K, N) weights (layer as the
// outer coordinate) and the (L, B, T, d) K/V caches (layer x B + row).
cudaError_t cached_map(const void* base, bool one_byte, uint64_t n0, uint64_t n1, uint64_t n2,
                       uint32_t box0, uint32_t box1, CUtensorMapSwizzle swizzle,
                       CUtensorMap* map) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    uint64_t n[3];
    uint32_t box[2];
    int one_byte, swizzle;
  };
  constexpr int SLOTS = 256;
  static Entry cache[SLOTS];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.base == base && c.one_byte == (int)one_byte && c.n[0] == n0 && c.n[1] == n1 &&
        c.n[2] == n2 && c.box[0] == box0 && c.box[1] == box1 && c.swizzle == (int)swizzle) {
      *map = c.map;
      return cudaSuccess;
    }
  }
  const uint64_t es = one_byte ? 1 : 2;
  const uint64_t dims[3] = {n0, n1, n2};
  const uint64_t strides[2] = {n0 * es, n1 * n0 * es};
  const uint32_t box[3] = {box0, box1, 1};
  Entry& c = cache[next];
  const cudaError_t e = encode_tensor_map(
      &c.map, one_byte ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      base, dims, strides, box, swizzle);
  if (e != cudaSuccess) {
    c.base = nullptr;
    return e;
  }
  c.base = base;
  c.n[0] = n0;
  c.n[1] = n1;
  c.n[2] = n2;
  c.box[0] = box0;
  c.box[1] = box1;
  c.one_byte = one_byte;
  c.swizzle = swizzle;
  *map = c.map;
  next = (next + 1) % SLOTS;
  used = used < SLOTS ? used + 1 : SLOTS;
  return cudaSuccess;
}

// a stacked (L, K, N) weight: boxes of KS rows x 64 columns, bf16 128-byte
// swizzled, int8 as they are
cudaError_t weight_map(const void* base, bool w8, int L, int K, int N, CUtensorMap* map) {
  return cached_map(base, w8, N, K, L, MLP_TILE, MLP_KS,
                    w8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B, map);
}

// (L x rows, T, d) K or V: boxes of 64 keys x one head, bf16 rows of 128
// bytes swizzled 128, int8 rows of 64 bytes swizzled 64
cudaError_t kv_map(const void* base, bool kv8, int rows, int T, int d, CUtensorMap* map) {
  return cached_map(base, kv8, d, T, rows, HD, KV_BOX,
                    kv8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B, map);
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// a launch that may start before the kernel before it ends (programmatic
// dependent launch), which it waits for with griddepcontrol.wait
template <typename Kernel, typename... Args>
cudaError_t launch_pdl(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t st,
                       Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename WT, int NP, int KIND>
cudaError_t prod_launch(ProdArgs a, const void* w, int L, float* work, long long work_floats,
                        cudaStream_t st) {
  constexpr bool LN = ln_kind<KIND>();
  const int tiles = a.N / MLP_TILE;
  a.steps = (a.K + MLP_KS - 1) / MLP_KS;
  // split K so that tiles x splits blocks fill the SMs in one wave (fc1 at
  // large-v3: 80 x 1; fc2: 20 x 6; q and wo: 20 x 6)
  a.splits = max(1, min(a.steps, sm_count() / tiles));
  a.sums = work;
  const int span = (a.steps + a.splits - 1) / a.splits;   // the most steps a block takes
  const int act_bytes = (LN ? a.steps : span) * (MLP_KS / 64) * NP * 128;
  const int smem = prod_smem<WT, NP, KIND>(act_bytes);
  if ((LN && a.K > MLP_MAX_D) || act_bytes > NP * MLP_MAX_D * 2 || tiles > MLP_COUNTERS ||
      smem > SMEM_OPTIN ||
      (a.splits > 1 && (long long)tiles * a.splits * (NP / 2) * MLP_CONSUMERS > work_floats))
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = weight_map(w, sizeof(WT) == 1, L, a.K, a.N, &map);
  if (e != cudaSuccess) return e;
  auto kernel = KIND == P_FC1   ? mlp_fc1_kernel<WT, NP>
                : KIND == P_FC2 ? mlp_fc2_kernel<WT, NP>
                : KIND == P_Q   ? attn_q_kernel<WT, NP>
                                : attn_wo_kernel<WT, NP>;
  static bool done[64] = {};
  if ((e = allow_dynamic_smem(kernel, SMEM_OPTIN, done)) != cudaSuccess) return e;
  e = launch_pdl(kernel, dim3(tiles, a.splits, 1), MLP_THREADS, smem, st, map, a);
  ++g_launches[KIND == P_FC1   ? K_MLP1
               : KIND == P_FC2 ? K_MLP2
               : KIND == P_Q   ? K_ATTN_Q
                               : K_ATTN_WO];
  return e;
}

// one product of a pass of n rows, NP = n padded to 8, 16 or 32
template <int KIND>
cudaError_t prod(const ProdArgs& a, const void* w, int L, float* work, long long work_floats,
                 cudaStream_t st) {
  auto go = [&](auto np) {
    constexpr int NP = decltype(np)::value;
    return a.w_scale != nullptr
               ? prod_launch<int8_t, NP, KIND>(a, w, L, work, work_floats, st)
               : prod_launch<__nv_bfloat16, NP, KIND>(a, w, L, work, work_floats, st);
  };
  return a.B <= 8    ? go(std::integral_constant<int, 8>{})
         : a.B <= 16 ? go(std::integral_constant<int, 16>{})
                     : go(std::integral_constant<int, 32>{});
}

// bf16 fused_mlp: passes of up to MLP_MAX_ROWS rows, two launches each (fc1,
// fc2); rows beyond 32 take further passes, each streaming the weights again.
cudaError_t mlp_tc(const __nv_bfloat16* x, const float* ln_s, const float* ln_b, const void* w1,
                   const __nv_bfloat16* b1, const void* w2, const __nv_bfloat16* b2,
                   const float* s1, const float* s2, __nv_bfloat16* g, __nv_bfloat16* out,
                   float* work, long long work_floats, int* counters, int B, int d, int ff,
                   int l1, int L1, int l2, int L2, cudaStream_t st) {
  if (B < 1 || d % MLP_TILE != 0 || ff % MLP_TILE != 0 || d > MLP_MAX_D || l1 < 0 ||
      l1 >= L1 || l2 < 0 || l2 >= L2)
    return cudaErrorInvalidValue;
  for (int r0 = 0; r0 < B; r0 += MLP_MAX_ROWS) {
    const int n = min(MLP_MAX_ROWS, B - r0);
    ProdArgs a1{};
    a1.x = x + (long long)r0 * d;
    a1.ln_s = ln_s;
    a1.ln_b = ln_b;
    a1.bias = b1;
    a1.w_scale = s1;
    a1.out = g + (long long)r0 * ff;
    a1.B = n;
    a1.K = d;
    a1.N = ff;
    a1.layer = l1;
    a1.counters = counters;
    ProdArgs a2{};
    a2.x = a1.x;
    a2.act = g + (long long)r0 * ff;
    a2.bias = b2;
    a2.w_scale = s2;
    a2.out = out + (long long)r0 * d;
    a2.B = n;
    a2.K = ff;
    a2.N = d;
    a2.layer = l2;
    a2.counters = counters + MLP_COUNTERS;
    cudaError_t e = prod<P_FC1>(a1, w1, L1, work, work_floats, st);
    if (e == cudaSuccess) e = prod<P_FC2>(a2, w2, L2, work, work_floats, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int NP>
cudaError_t qkv_launch(const QkvArgs& a, const CUtensorMap (&m)[4], int tiles, int act_bytes,
                       cudaStream_t st) {
  auto kernel = qkv_kernel<NP>;
  // the block's layout is its weight type's: launch with the larger
  const int smem = max(prod_smem<__nv_bfloat16, NP, P_QKV>(act_bytes),
                       prod_smem<int8_t, NP, P_QKV>(act_bytes));
  if (smem > SMEM_OPTIN) return cudaErrorInvalidValue;
  static bool done[64] = {};
  cudaError_t e = allow_dynamic_smem(kernel, SMEM_OPTIN, done);
  if (e != cudaSuccess) return e;
  e = launch_pdl(kernel, dim3(3 * tiles, a.p[0].splits, 1), MLP_THREADS, smem, st, m[0], m[1],
                 m[2], m[3], a);
  ++g_launches[K_QKV];
  return e;
}

// bf16 fused_qkv: passes of up to MLP_MAX_ROWS rows, one launch each; w[i],
// the stacked (L[i], d, d) bases of q, k, v, read at layer[i]; out[i] with
// a row stride of ld[i] elements (k and v: a cache's row pos, or its row 0
// with pos, the position on the card, below pos_limit); sums and counters
// the kernel's own regions of the workspace.
cudaError_t qkv_tc(const __nv_bfloat16* x, const float* ln_s, const float* ln_b,
                   const void* const (&w)[3], const __nv_bfloat16* const (&bias)[3],
                   const float* const (&scale)[3], const int (&layer)[3], const int (&L)[3],
                   void* const (&out)[3], const long long (&ld)[3], const long long* pos,
                   int pos_limit, float* sums, long long sums_floats, int* counters, int B,
                   int d, cudaStream_t st) {
  if (B < 1 || d % MLP_TILE != 0 || d > MLP_MAX_D) return cudaErrorInvalidValue;
  const int tiles = d / MLP_TILE, steps = (d + MLP_KS - 1) / MLP_KS;
  if (3 * tiles > MLP_COUNTERS) return cudaErrorInvalidValue;
  // K split so that the three projections' tiles fill the SMs in one wave
  // (large-v3: 60 x 2)
  const int splits = max(1, min(steps, sm_count() / (3 * tiles)));
  CUtensorMap m[4];
  for (int i = 0; i < 3; ++i) {
    if (layer[i] < 0 || layer[i] >= L[i] || ld[i] < d) return cudaErrorInvalidValue;
    const cudaError_t e = weight_map(w[i], scale[i] != nullptr, L[i], d, d, &m[i]);
    if (e != cudaSuccess) return e;
  }
  for (int r0 = 0; r0 < B; r0 += MLP_MAX_ROWS) {
    const int n = min(MLP_MAX_ROWS, B - r0);
    const int np = n <= 8 ? 8 : n <= 16 ? 16 : 32;
    const long long per = (long long)tiles * splits * (np / 2) * MLP_CONSUMERS;
    if (splits > 1 && 3 * per > sums_floats) return cudaErrorInvalidValue;
    QkvArgs a{};
    for (int i = 0; i < 3; ++i) {
      ProdArgs& pa = a.p[i];
      pa.x = x + (long long)r0 * d;
      pa.ln_s = ln_s;
      pa.ln_b = ln_b;
      pa.bias = bias[i];
      pa.w_scale = scale[i];
      pa.out = i == 0 ? static_cast<void*>(static_cast<float*>(out[0]) + r0 * ld[0])
                      : static_cast<void*>(static_cast<__nv_bfloat16*>(out[i]) + r0 * ld[i]);
      pa.sums = sums + i * per;
      pa.counters = counters + i * tiles;
      pa.B = n;
      pa.K = d;
      pa.N = d;
      pa.layer = layer[i];
      pa.splits = splits;
      pa.steps = steps;
      pa.out_ld = ld[i];
      pa.role = i;
      pa.pos = pos;
      pa.pos_limit = pos_limit;
      if (scale[i] != nullptr) a.w8 |= 1 << i;
    }
    const int act_bytes = steps * (MLP_KS / 64) * np * 128;   // LN(x)'s whole rows
    {   // x's (d, B) rows: boxes of 64 columns x np rows, 128-byte swizzled;
        // rows past B land as zeros
      const cudaError_t e = cached_map(x, false, d, B, 1, 64, np, CU_TENSOR_MAP_SWIZZLE_128B, &m[3]);
      if (e != cudaSuccess) return e;
      for (int i = 0; i < 3; ++i) a.p[i].x_row0 = r0;
    }
    const cudaError_t e = np == 8    ? qkv_launch<8>(a, m, tiles, act_bytes, st)
                          : np == 16 ? qkv_launch<16>(a, m, tiles, act_bytes, st)
                                     : qkv_launch<32>(a, m, tiles, act_bytes, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename KV, int MAXG>
cudaError_t core_launch(const CoreArgs& a, const CUtensorMap& km, const CUtensorMap& vm,
                        int n_groups, cudaStream_t st) {
  auto kernel = attn_chunk_kernel<KV, MAXG>;
  constexpr int smem = core_smem<KV, MAXG>();
  static bool done[64] = {};
  cudaError_t e = allow_dynamic_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  e = launch_pdl(kernel, dim3(a.n_split, a.d / HD, n_groups * a.n_sub), CORE_THREADS, smem, st,
                 km, vm, a);
  ++g_launches[K_CHUNK];
  return e;
}

template <typename KV>
cudaError_t core(const CoreArgs& a, const CUtensorMap& km, const CUtensorMap& vm, int n_groups,
                 cudaStream_t st) {
  return a.gs == 1   ? core_launch<KV, 1>(a, km, vm, n_groups, st)
         : a.gs == 2 ? core_launch<KV, 2>(a, km, vm, n_groups, st)
         : a.gs <= 4 ? core_launch<KV, 4>(a, km, vm, n_groups, st)
                     : core_launch<KV, MAX_GROUP>(a, km, vm, n_groups, st);
}

// bf16 fused_attn: passes of up to 32 rows, each q (cross mode) -> the
// attention core -> wo with the combine, programmatic dependent launches
// all. A pass holds whole groups of G rows (G <= 32: 32 / G of them), or
// 32 rows of one wider group. wq, wo: stacked (Lq, d, d) / (Lo, d, d) bases
// read at lq / lo; k, v: stacked (Lkv, N / G, T_len, d) bases read at lkv.
// anc: beam self-attention (q given, G = 1, bf16 K/V, the (N, T_len)
// ancestry of `beam` hypotheses an utterance), the core gathering each key
// row through it; passes of 32 rows need not hold whole utterances. pos:
// self mode's position on the card (n_valid = *pos + 1, unused here), the
// core's grid then over the whole cache.
cudaError_t attn_tc(const __nv_bfloat16* x, const float* q, const float* ln_s,
                    const float* ln_b, const void* wq, const __nv_bfloat16* bq, const float* sq,
                    int lq, int Lq, const void* k, const void* v, const float* k_scale,
                    const float* v_scale, int lkv, int Lkv, const int* anc, int beam,
                    const void* wo, const __nv_bfloat16* bo, const float* so, int lo, int Lo,
                    float* q_buf, float* part, __nv_bfloat16* o_buf, __nv_bfloat16* out,
                    float* work, long long work_floats, int* counters, int N, int T_len, int d,
                    int n_valid, const long long* pos, int G, cudaStream_t st) {
  const bool cross = q == nullptr;
  if (pos != nullptr) n_valid = T_len;   // the grid's bound: every chunk of the cache
  const int n_split = (n_valid + ACH - 1) / ACH;
  if (N < 1 || G < 1 || N % G != 0 || d % MLP_TILE != 0 || d > MLP_MAX_D || n_valid < 1 ||
      n_valid > T_len || n_split > MAX_SPLIT || lkv < 0 || lkv >= Lkv || lo < 0 || lo >= Lo ||
      (cross && (lq < 0 || lq >= Lq)) || (pos != nullptr && (cross || anc != nullptr)) ||
      (anc != nullptr && (cross || G != 1 || beam < 1 || N % beam != 0 || k_scale != nullptr)))
    return cudaErrorInvalidValue;
  const bool kv8 = k_scale != nullptr;
  const int kv_rows = N / G;
  CUtensorMap km{}, vm{};   // beam mode gathers by address: no maps
  cudaError_t e = cudaSuccess;
  if (anc == nullptr) {
    e = kv_map(k, kv8, Lkv * kv_rows, T_len, d, &km);
    if (e == cudaSuccess) e = kv_map(v, kv8, Lkv * kv_rows, T_len, d, &vm);
    if (e != cudaSuccess) return e;
  }
  for (int r0 = 0; r0 < N;) {
    const int n = G <= MLP_MAX_ROWS ? min(N - r0, MLP_MAX_ROWS / G * G)
                                    : min(MLP_MAX_ROWS, G - r0 % G);
    if (cross) {
      ProdArgs aq{};
      aq.x = x + (long long)r0 * d;
      aq.ln_s = ln_s;
      aq.ln_b = ln_b;
      aq.bias = bq;
      aq.w_scale = sq;
      aq.out = q_buf + (long long)r0 * d;
      aq.B = n;
      aq.K = d;
      aq.N = d;
      aq.layer = lq;
      aq.counters = counters + 2 * MLP_COUNTERS;
      if ((e = prod<P_Q>(aq, wq, Lq, work, work_floats, st)) != cudaSuccess) return e;
    }
    CoreArgs c{};
    c.q = cross ? q_buf : q;
    c.k_scale = k_scale;
    c.v_scale = v_scale;
    c.part = part;
    c.counters = counters + 4 * MLP_COUNTERS;
    c.o = o_buf;
    c.d = d;
    c.n_valid = n_valid;
    c.n_split = n_split;
    c.r0 = r0;
    c.Gp = min(G, n);
    c.gs = min(c.Gp, MAX_GROUP);
    c.n_sub = (c.Gp + c.gs - 1) / c.gs;
    c.G = G;
    c.kv_row0 = lkv * kv_rows;
    c.kv_early = cross;
    c.anc = anc;
    c.kb = static_cast<const __nv_bfloat16*>(k);
    c.vb = static_cast<const __nv_bfloat16*>(v);
    c.beam = beam;
    c.T_len = T_len;
    c.pos = pos;
    e = kv8 ? core<int8_t>(c, km, vm, n / c.Gp, st) : core<__nv_bfloat16>(c, km, vm, n / c.Gp, st);
    if (e != cudaSuccess) return e;
    ProdArgs ao{};
    ao.x = x + (long long)r0 * d;
    ao.act = o_buf + (long long)r0 * d;
    ao.bias = bo;
    ao.w_scale = so;
    ao.out = out + (long long)r0 * d;
    ao.B = n;
    ao.K = d;
    ao.N = d;
    ao.layer = lo;
    ao.counters = counters + 3 * MLP_COUNTERS;
    if ((e = prod<P_WO>(ao, wo, Lo, work, work_floats, st)) != cudaSuccess) return e;
    r0 += n;
  }
  return cudaSuccess;
}

}  // namespace

// C entries. dtype: 0 = float32, 1 = bfloat16 (activations, float weights,
// biases and caches); LN scale/bias and q are fp32. A weight whose scale
// pointer (sq, sk, sv, so, s1, s2: (N,) fp32) is non-null is int8. Pointers
// are offset to the layer, except the stacked bases the tensor-core entries
// read at a layer index; every (B, n) array is contiguous. Scratch: q_buf
// (B, d) fp32, part (B, d/64, ceil(T/256), 66) fp32 (the GEMV route) or (B,
// d/64, ceil(T/64), PART) (fused_attn_tc_fwd), o_buf (B, d) and g_buf (B,
// ff) in dtype. fused_attn: N query rows over N / G KV rows of T_len
// positions; k/v int8 when k_scale/v_scale ((N / G, d) fp32) are non-null.

extern "C" int fused_qkv_fwd(int dtype, const void* x, const float* ln_s, const float* ln_b,
                             const void* wq, const void* bq, const void* wk, const void* wv,
                             const void* bv, const float* sq, const float* sk, const float* sv,
                             float* q_out, void* k_out, void* v_out, int B, int d,
                             void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);   // bf16: fused_qkv_tc_fwd
  return static_cast<int>(qkv<float>(x, ln_s, ln_b, wq, bq, wk, wv, bv, sq, sk, sv, q_out, k_out,
                                     v_out, B, d, static_cast<cudaStream_t>(stream)));
}

// bf16 fused_qkv on the tensor cores: wq, wk, wv are stacked (L, d, d)
// bases read at their layer (L = 1 for one layer's), int8 where their scale
// (sq, sk, sv) is non-null; biases, scales and LN offset to the layer. q_out
// (B, d) fp32; k_out and v_out bf16 rows k_ld and v_ld elements apart (d,
// or a self cache's T x d with the pointer at position pos of the layer;
// with pos_dev, the position on the card, at row 0 of the layer, k and v
// going to row *pos_dev when it lies in [0, pos_limit)). sums (sums_floats
// fp32) and counters (1024 int32, zero before the first call; each call
// leaves them zero) are this kernel's own.
extern "C" int fused_qkv_tc_fwd(const void* x, const float* ln_s, const float* ln_b,
                                const void* wq, const void* bq, const float* sq, int lq, int Lq,
                                const void* wk, const float* sk, int lk, int Lk, const void* wv,
                                const void* bv, const float* sv, int lv, int Lv, float* q_out,
                                void* k_out, long long k_ld, void* v_out, long long v_ld,
                                const long long* pos_dev, int pos_limit, float* sums,
                                long long sums_floats, int* counters, int B, int d,
                                void* stream) {
  using bf = __nv_bfloat16;
  const void* const w[3] = {wq, wk, wv};
  const bf* const bias[3] = {static_cast<const bf*>(bq), nullptr, static_cast<const bf*>(bv)};
  const float* const scale[3] = {sq, sk, sv};
  const int layer[3] = {lq, lk, lv}, L[3] = {Lq, Lk, Lv};
  void* const out[3] = {q_out, k_out, v_out};
  const long long ld[3] = {d, k_ld, v_ld};
  return static_cast<int>(qkv_tc(static_cast<const bf*>(x), ln_s, ln_b, w, bias, scale, layer,
                                 L, out, ld, pos_dev, pos_limit, sums, sums_floats, counters,
                                 B, d, static_cast<cudaStream_t>(stream)));
}

// fp32 fused_attn: the GEMVs, the split-T partials and their combine;
// pos (self mode, or null): the position on the card, n_valid = *pos + 1
extern "C" int fused_attn_fwd(int dtype, const void* x, const float* q, const float* ln_s,
                              const float* ln_b, const void* wq, const void* bq, const void* k,
                              const void* v, const float* k_scale, const float* v_scale,
                              const void* wo, const void* bo, const float* sq, const float* so,
                              float* q_buf, float* part, void* o_buf, void* out, int N,
                              int T_len, int d, int n_valid, const long long* pos, int G,
                              void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);   // bf16: fused_attn_tc_fwd
  if (pos != nullptr && q == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a = attn_args(q, k, v, k_scale, nullptr, part, T_len, d, n_valid, G, 1, pos);
  return static_cast<int>(attn<float>(x, ln_s, ln_b, wq, bq, sq, a, v_scale, wo, bo, so, q_buf,
                                      o_buf, out, N, static_cast<cudaStream_t>(stream)));
}

// bf16 fused_attn on the tensor-core products and the chunk core: wq (Lq,
// d, d) and wo (Lo, d, d) are stacked bases read at lq and lo, k and v
// (Lkv, N / G, T_len, d) stacked bases read at lkv (L = 1 for one layer's);
// the scales are offset to the layer. q given: self mode (q (N, d) fp32);
// q null: cross mode, q computed into q_buf from LN(x); o_buf (N, d) bf16
// takes the attention's output. work and counters are fused_mlp_fwd's
// (counters 5 x 1024: fused_attn takes the last three). pos (self mode, or
// null): the position on the card, n_valid = *pos + 1 read there, the
// core's grid over the whole cache.
extern "C" int fused_attn_tc_fwd(const void* x, const float* q, const float* ln_s,
                                 const float* ln_b, const void* wq, const void* bq,
                                 const float* sq, int lq, int Lq, const void* k, const void* v,
                                 const float* k_scale, const float* v_scale, int lkv, int Lkv,
                                 const void* wo, const void* bo, const float* so, int lo, int Lo,
                                 float* q_buf, float* part, void* o_buf, void* out, float* work,
                                 long long work_floats, int* counters, int N, int T_len, int d,
                                 int n_valid, const long long* pos, int G, void* stream) {
  using bf = __nv_bfloat16;
  return static_cast<int>(attn_tc(
      static_cast<const bf*>(x), q, ln_s, ln_b, wq, static_cast<const bf*>(bq), sq, lq, Lq, k,
      v, k_scale, v_scale, lkv, Lkv, nullptr, 0, wo, static_cast<const bf*>(bo), so, lo, Lo,
      q_buf, part,
      static_cast<bf*>(o_buf), static_cast<bf*>(out), work, work_floats, counters, N, T_len, d,
      n_valid, pos, G, static_cast<cudaStream_t>(stream)));
}

// fp32 beam self-attention over the unpermuted cache, the GEMV route: anc
// (N, T_len) int32, the (B, beam, T_len) ancestry map; query row r reads
// position t from cache row (r - r % beam) + anc[r, t]. k and v are offset
// to the layer.
extern "C" int fused_attn_beam_fwd(int dtype, const void* x, const float* q, const void* k,
                                   const void* v, const int* anc, const void* wo,
                                   const void* bo, const float* so, float* part, void* o_buf,
                                   void* out, int N, int T_len, int d, int n_valid, int beam,
                                   void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);   // bf16: the _tc entry
  const AttnArgs a = attn_args(q, k, v, nullptr, anc, part, T_len, d, n_valid, 1, beam);
  return static_cast<int>(attn<float>(x, nullptr, nullptr, nullptr, nullptr, nullptr, a, nullptr,
                                      wo, bo, so, nullptr, o_buf, out, N,
                                      static_cast<cudaStream_t>(stream)));
}

// bf16 beam self-attention on the attention core in beam mode and the wo
// product, two programmatic dependent launches a pass of up to 32 rows: k
// and v are the stacked (Lkv, N, T_len, d) cache bases read at lkv, wo (Lo,
// d, d) read at lo, int8 where so is non-null; anc as fused_attn_beam_fwd's;
// part, o_buf, work and counters as fused_attn_tc_fwd's.
extern "C" int fused_attn_beam_tc_fwd(const void* x, const float* q, const void* k,
                                      const void* v, int lkv, int Lkv, const int* anc,
                                      const void* wo, const void* bo, const float* so, int lo,
                                      int Lo, float* part, void* o_buf, void* out, float* work,
                                      long long work_floats, int* counters, int N, int T_len,
                                      int d, int n_valid, int beam, void* stream) {
  using bf = __nv_bfloat16;
  if (q == nullptr || anc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(attn_tc(
      static_cast<const bf*>(x), q, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, k, v,
      nullptr, nullptr, lkv, Lkv, anc, beam, wo, static_cast<const bf*>(bo), so, lo, Lo, nullptr,
      part, static_cast<bf*>(o_buf), static_cast<bf*>(out), work, work_floats, counters, N,
      T_len, d, n_valid, nullptr, 1, static_cast<cudaStream_t>(stream)));
}

// fused_mlp: w1 (L1, d, ff) and w2 (L2, ff, d) are the stacked weights' bases
// (L = 1 for one layer's), read at layers l1 and l2; every other pointer is
// already offset to its layer. bf16 runs the tensor-core kernels, which take
// d and ff as multiples of 64 and d <= 1280 and use work (work_floats fp32:
// split-K partial sums) and counters (5 x 1024 int32, zero before the first
// call; each call leaves them zero; fused_mlp takes the first two); fp32
// runs the GEMVs.
extern "C" int fused_mlp_fwd(int dtype, const void* x, const float* ln_s, const float* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const float* s1, const float* s2, void* g_buf, void* out,
                             float* work, long long work_floats, int* counters, int B, int d,
                             int ff, int l1, int L1, int l2, int L2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const long long per = (long long)d * ff;
    const char* w1l = static_cast<const char*>(w1) + l1 * per * (s1 != nullptr ? 1 : 4);
    const char* w2l = static_cast<const char*>(w2) + l2 * per * (s2 != nullptr ? 1 : 4);
    return static_cast<int>(
        mlp<float>(x, ln_s, ln_b, w1l, b1, w2l, b2, s1, s2, g_buf, out, B, d, ff, st));
  }
  using bf = __nv_bfloat16;
  return static_cast<int>(mlp_tc(static_cast<const bf*>(x), ln_s, ln_b, w1,
                                 static_cast<const bf*>(b1), w2, static_cast<const bf*>(b2), s1,
                                 s2, static_cast<bf*>(g_buf), static_cast<bf*>(out), work,
                                 work_floats, counters, B, d, ff, l1, L1, l2, L2, st));
}

// out[9] = launches of gemv_kernel, attn_partial_kernel, attn_combine_kernel,
// mlp_fc1_kernel, mlp_fc2_kernel, attn_q_kernel, attn_chunk_kernel,
// attn_wo_kernel, qkv_kernel since the last reset
extern "C" void kernel_launches(long long* out) {
  for (int i = 0; i < N_KERNELS; ++i) out[i] = g_launches[i];
}

#ifdef MLP_TRACE
extern "C" int mlp_trace(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_mlp_trace, sizeof(g_mlp_trace)));
}
#endif

#ifdef ATTN_TRACE
// out: the probe's (3, 4096, 4) stamps, then zeroed for the next call
extern "C" int attn_trace(unsigned long long* out) {
  static unsigned long long zeros[3 * 4096 * 4] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_attn_trace, sizeof(g_attn_trace));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_attn_trace, zeros, sizeof(g_attn_trace));
  return static_cast<int>(e);
}
#endif

extern "C" void reset_kernel_launches() {
  for (int i = 0; i < N_KERNELS; ++i) g_launches[i] = 0;
}
