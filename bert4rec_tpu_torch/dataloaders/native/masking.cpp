// Native MLM masking engine.
//
// Multithreaded C++ implementation of the per-epoch dynamic-masking pass
// (semantics of bert4rec_tpu/dataloaders/dataloader_utils.py
// apply_dynamic_masking_batch, itself the vectorized rebuild of the
// reference's apply_dynamic_masking_task, dataloader_utils.py:186-261):
//
//   num_to_predict = min(P, max(1, n_valid * selection_rate))
//   positions drawn uniformly without replacement among valid (in-length,
//   non-special) tokens, emitted ascending; per position one uniform draw:
//   rn < mask_rate -> [MASK]; < mask_rate+random_rate -> random non-special
//   token; else keep. Finetuning rows mask exactly the last token.
//
// Determinism: a splitmix64 stream seeded by (seed, row) makes results
// independent of the thread schedule. The host pipeline feeds one chip at
// ~38k examples/s from numpy; this engine exists so a full 8-chip host
// (>100k examples/s) stays compute-bound, not input-bound.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread masking.cpp -o libmasking.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

inline double uniform01(uint64_t& state) {
  return (splitmix64(state) >> 11) * (1.0 / 9007199254740992.0);
}

// uniform integer in [0, n) without modulo bias (n << 2^64 so simple
// rejection on the top range is fine)
inline uint64_t uniform_int(uint64_t& state, uint64_t n) {
  uint64_t threshold = (~n + 1) % n;  // (2^64 - n) % n
  for (;;) {
    uint64_t r = splitmix64(state);
    if (r >= threshold) return r % n;
  }
}

struct Args {
  const int32_t* input_ids;
  const int32_t* lengths;
  const uint8_t* finetuning;
  int64_t n, s, p;
  int32_t mask_token_id;
  const int32_t* special_ids;
  int64_t n_special;
  int32_t vocab_size;
  double selection_rate, mask_rate, random_rate;
  uint64_t seed;
  int32_t* masked_input;
  int32_t* mlm_positions;
  int32_t* mlm_ids;
  int32_t* mlm_weights;
};

inline bool is_special(const Args& a, int32_t id) {
  for (int64_t i = 0; i < a.n_special; ++i)
    if (a.special_ids[i] == id) return true;
  return false;
}

inline int32_t random_token(const Args& a, uint64_t& rng) {
  // specials are a handful of ids: rejection sampling terminates fast
  for (;;) {
    int32_t cand = static_cast<int32_t>(
        uniform_int(rng, static_cast<uint64_t>(a.vocab_size)));
    if (!is_special(a, cand)) return cand;
  }
}

void process_row(const Args& a, int64_t row, std::vector<int32_t>& valid_buf) {
  const int32_t* in = a.input_ids + row * a.s;
  int32_t* out = a.masked_input + row * a.s;
  std::memcpy(out, in, sizeof(int32_t) * a.s);

  int32_t* pos_out = a.mlm_positions + row * a.p;
  int32_t* ids_out = a.mlm_ids + row * a.p;
  int32_t* w_out = a.mlm_weights + row * a.p;
  std::memset(pos_out, 0, sizeof(int32_t) * a.p);
  std::memset(ids_out, 0, sizeof(int32_t) * a.p);
  std::memset(w_out, 0, sizeof(int32_t) * a.p);

  const int32_t len = std::min<int32_t>(a.lengths[row],
                                        static_cast<int32_t>(a.s));
  uint64_t rng = a.seed * 0x9E3779B97F4A7C15ULL + 0xD1B54A32D192ED03ULL *
                 static_cast<uint64_t>(row + 1);
  splitmix64(rng);  // decorrelate nearby rows

  if (a.finetuning && a.finetuning[row]) {
    // last-token-only mask (reference mask_last_token_only, :264-269)
    if (len > 0) {
      pos_out[0] = len - 1;
      ids_out[0] = in[len - 1];
      w_out[0] = 1;
      out[len - 1] = a.mask_token_id;
    }
    return;
  }

  valid_buf.clear();
  for (int32_t i = 0; i < len; ++i)
    if (!is_special(a, in[i])) valid_buf.push_back(i);
  const int64_t n_valid = static_cast<int64_t>(valid_buf.size());
  if (n_valid == 0) return;

  int64_t k = static_cast<int64_t>(n_valid * a.selection_rate);
  if (k < 1) k = 1;
  if (k > a.p) k = a.p;
  if (k > n_valid) k = n_valid;

  // partial Fisher-Yates: first k entries = uniform sample w/o replacement
  for (int64_t i = 0; i < k; ++i) {
    int64_t j = i + static_cast<int64_t>(
        uniform_int(rng, static_cast<uint64_t>(n_valid - i)));
    std::swap(valid_buf[i], valid_buf[j]);
  }
  std::sort(valid_buf.begin(), valid_buf.begin() + k);

  for (int64_t i = 0; i < k; ++i) {
    const int32_t pos = valid_buf[i];
    pos_out[i] = pos;
    ids_out[i] = in[pos];
    w_out[i] = 1;
    const double rn = uniform01(rng);
    if (rn < a.mask_rate) {
      out[pos] = a.mask_token_id;
    } else if (rn < a.mask_rate + a.random_rate) {
      out[pos] = random_token(a, rng);
    }  // else: keep the original token
  }
}

}  // namespace

extern "C" {

void apply_dynamic_masking_batch(
    const int32_t* input_ids, const int32_t* lengths,
    const uint8_t* finetuning, int64_t n, int64_t s, int64_t p,
    int32_t mask_token_id, const int32_t* special_ids, int64_t n_special,
    int32_t vocab_size, double selection_rate, double mask_rate,
    double random_rate, uint64_t seed, int32_t n_threads,
    int32_t* masked_input, int32_t* mlm_positions, int32_t* mlm_ids,
    int32_t* mlm_weights) {
  Args a{input_ids, lengths,   finetuning,     n,
         s,         p,         mask_token_id,  special_ids,
         n_special, vocab_size, selection_rate, mask_rate,
         random_rate, seed,    masked_input,   mlm_positions,
         mlm_ids,   mlm_weights};

  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads == 1 || n < 2 * n_threads) {
    std::vector<int32_t> buf;
    buf.reserve(static_cast<size_t>(s));
    for (int64_t row = 0; row < n; ++row) process_row(a, row, buf);
    return;
  }

  std::atomic<int64_t> next_chunk{0};
  const int64_t chunk = 256;
  auto worker = [&]() {
    std::vector<int32_t> buf;
    buf.reserve(static_cast<size_t>(s));
    for (;;) {
      const int64_t start = next_chunk.fetch_add(chunk);
      if (start >= n) break;
      const int64_t stop = std::min(start + chunk, n);
      for (int64_t row = start; row < stop; ++row) process_row(a, row, buf);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
