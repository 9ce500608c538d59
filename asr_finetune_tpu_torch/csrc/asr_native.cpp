// asr_native: the port's host C++ path (a copy of native/asr_native.cpp).
//
//  - `edit_distance_u32` / `corpus_wer_u32`: word-level Levenshtein over
//    interned word ids (two-row DP), the corpus fanned out over a small
//    thread pool: the WER of evaluation/wer.py;
//  - `assemble_batch_f32`: pads or trims N variable-length waveforms into a
//    contiguous (N, target_len) float32 batch, the collator's audio
//    (data/collator.py); `int16_to_f32` converts PCM16.
//
// Built at first use with g++ into build/torch_native/ and bound with
// ctypes by asr_finetune_tpu_torch/utils/native_ext.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Levenshtein distance between two sequences of uint32 word ids.
// Two-row DP, O(min) memory.
int64_t edit_distance_u32(const uint32_t* a, int64_t na,
                          const uint32_t* b, int64_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const uint32_t ai = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t cost = (ai == b[j - 1]) ? 0 : 1;
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// Corpus WER numerator/denominator over a packed batch of utterance pairs.
// refs/hyps are concatenated uint32 word-id streams with prefix offsets
// (ref_off[i]..ref_off[i+1]). Fan-out over a small thread pool.
// Returns total edit errors; *total_ref_words gets the denominator.
int64_t corpus_wer_u32(const uint32_t* refs, const int64_t* ref_off,
                       const uint32_t* hyps, const int64_t* hyp_off,
                       int64_t n_pairs, int64_t n_threads,
                       int64_t* total_ref_words) {
  std::atomic<int64_t> next(0);
  std::vector<int64_t> errors(std::max<int64_t>(n_threads, 1), 0);
  std::vector<int64_t> words(std::max<int64_t>(n_threads, 1), 0);

  auto work = [&](int64_t tid) {
    int64_t i;
    while ((i = next.fetch_add(1)) < n_pairs) {
      const uint32_t* r = refs + ref_off[i];
      const int64_t nr = ref_off[i + 1] - ref_off[i];
      const uint32_t* h = hyps + hyp_off[i];
      const int64_t nh = hyp_off[i + 1] - hyp_off[i];
      errors[tid] += edit_distance_u32(r, nr, h, nh);
      words[tid] += nr;
    }
  };

  if (n_threads <= 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }
  int64_t e = 0, w = 0;
  for (size_t t = 0; t < errors.size(); ++t) { e += errors[t]; w += words[t]; }
  *total_ref_words = w;
  return e;
}

// Pad/trim N waveforms into a contiguous (n, target_len) float32 batch.
// srcs: array of pointers; lens: per-waveform lengths. Zero-fills the tail.
void assemble_batch_f32(const float** srcs, const int64_t* lens, int64_t n,
                        int64_t target_len, float* out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n) {
      float* dst = out + i * target_len;
      const int64_t copy = std::min(lens[i], target_len);
      std::memcpy(dst, srcs[i], copy * sizeof(float));
      if (copy < target_len)
        std::memset(dst + copy, 0, (target_len - copy) * sizeof(float));
    }
  };
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
}

// PCM16 → float32 in [-1, 1).
void int16_to_f32(const int16_t* src, int64_t n, float* out) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) out[i] = src[i] * kScale;
}

}  // extern "C"
