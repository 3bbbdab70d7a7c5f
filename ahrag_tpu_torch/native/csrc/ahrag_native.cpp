// Copied verbatim from ahrag_tpu/native/ahrag_native.cpp; only this line is added.
// ahrag_native: C++ runtime kernels around the TPU compute path.
//
// The reference delegates its native-performance work to third-party wheels
// (hnswlib inside ChromaDB, torch ATen, tiktoken's Rust BPE — SURVEY §2.3).
// This library provides the first-party equivalents for the host side:
//
//   - ell_build:        padded ELL adjacency construction (the graph-compiler
//                       hot path feeding GraphTensors);
//   - ell_max_degree:   degree scan used to size ELL rows;
//   - token_estimate:   fast BPE-approximating token count (words + digits +
//                       punctuation + CJK, calibrated against cl100k);
//   - exact_topk_f32:   blocked exact cosine top-k (the honest CPU baseline
//                       the bench compares the TPU path against).
//
// Exposed as a plain C ABI consumed via ctypes (ahrag_tpu/native/__init__.py);
// every entry point has a pure-Python fallback so the framework runs unbuilt.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <cstring>
#include <vector>

extern "C" {

// Scan edge list degrees. src: [n_edges] source node ids. Returns max degree.
int32_t ell_max_degree(const int32_t* src, int64_t n_edges, int32_t n_nodes) {
  std::vector<int32_t> deg(n_nodes, 0);
  int32_t maxd = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    int32_t s = src[e];
    if (s < 0 || s >= n_nodes) continue;
    maxd = std::max(maxd, ++deg[s]);
  }
  return maxd;
}

// Build a padded ELL table: out [n_pad, k] int32, pre-filled with -1 by caller.
// Neighbors keep edge order (insertion order — load-bearing for expansion
// parity, see graph/tensors.py docstring). Rows overflowing k are truncated.
void ell_build(const int32_t* src, const int32_t* dst, int64_t n_edges,
               int32_t n_nodes, int32_t n_pad, int32_t k, int32_t* out) {
  std::vector<int32_t> fill(n_nodes, 0);
  (void)n_pad;
  for (int64_t e = 0; e < n_edges; ++e) {
    int32_t s = src[e];
    if (s < 0 || s >= n_nodes) continue;
    int32_t pos = fill[s];
    if (pos >= k) continue;
    out[static_cast<int64_t>(s) * k + pos] = dst[e];
    fill[s] = pos + 1;
  }
}

// Fast token estimate: approximates cl100k BPE counts without a vocabulary.
// Heuristic: 1 token per word chunk of <=4 chars (longer words count
// ceil(len/4)), 1 per punctuation/symbol run char, 1 per digit pair, ~1 per
// CJK codepoint. Matches the reference's public fallback contract
// (context_processor.py:12-22: >= 1 for non-empty text).
int64_t token_estimate(const char* text, int64_t len) {
  if (len <= 0) return 0;
  int64_t tokens = 0;
  int64_t word_len = 0, digit_len = 0;
  auto flush_word = [&]() {
    if (word_len > 0) tokens += (word_len + 3) / 4;
    word_len = 0;
  };
  auto flush_digits = [&]() {
    if (digit_len > 0) tokens += (digit_len + 1) / 2;
    digit_len = 0;
  };
  for (int64_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c >= 0xE0) {           // 3/4-byte UTF-8 lead (CJK etc.): ~1 token each
      flush_word();
      flush_digits();
      ++tokens;
      i += (c >= 0xF0) ? 3 : 2;
    } else if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c >= 0x80) {
      flush_digits();
      ++word_len;
    } else if (c >= '0' && c <= '9') {
      flush_word();
      ++digit_len;
    } else if (c == ' ' || c == '\n' || c == '\t' || c == '\r') {
      flush_word();
      flush_digits();
    } else {  // punctuation / symbols
      flush_word();
      flush_digits();
      ++tokens;
    }
  }
  flush_word();
  flush_digits();
  return tokens > 0 ? tokens : 1;
}

// Hashed n-gram featurization for the default encoder: lowercased [a-z0-9]+
// words -> word unigrams + bigrams + char 3..5-grams of the space-joined word
// string, each FNV-1a-64 hashed into `buckets` counts. Must stay bit-identical
// to the Python fallback in models/encoder/hashed.py (same features, same hash)
// so graphs built with either path are queryable by the other.
static inline uint64_t fnv1a(const char* s, int64_t len, uint64_t h = 14695981039346656037ULL) {
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

}  // extern "C"

// Feature enumeration shared by the dense and COO entry points; `emit` is
// called once per feature occurrence with (bucket index, weight). Word
// unigrams/bigrams carry weight 1.0; char 3..5-grams carry `cg_weight` —
// at full weight the ~10x more numerous char-grams swamp word-level
// discrimination (two same-template docs differing in one rare token score
// near-identically), while a fractional weight keeps their morphology
// robustness (models/encoder/hashed.py mirrors this).
template <class Emit>
static void for_each_feature(const char* text, int64_t len, int32_t buckets,
                             float cg_weight, Emit emit) {
  // normalize: lowercase, non-[a-z0-9] -> separator; build the compact
  // space-joined word string
  std::vector<char> compact;
  compact.reserve(len + 1);
  std::vector<std::pair<int64_t, int64_t>> words;  // (start, len) into compact
  int64_t wstart = -1;
  for (int64_t i = 0; i <= len; ++i) {
    char c = (i < len) ? text[i] : ' ';
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
    bool ok = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
    if (ok) {
      if (wstart < 0) {
        if (!compact.empty()) compact.push_back(' ');
        wstart = static_cast<int64_t>(compact.size());
      }
      compact.push_back(c);
    } else if (wstart >= 0) {
      words.emplace_back(wstart, static_cast<int64_t>(compact.size()) - wstart);
      wstart = -1;
    }
  }
  const char* buf = compact.data();
  // word unigrams
  for (auto& w : words)
    emit(static_cast<int32_t>(fnv1a(buf + w.first, w.second) % buckets), 1.0f);
  // word bigrams: "a_b"
  for (size_t i = 0; i + 1 < words.size(); ++i) {
    uint64_t h = fnv1a(buf + words[i].first, words[i].second);
    h ^= static_cast<unsigned char>('_');
    h *= 1099511628211ULL;
    h = fnv1a(buf + words[i + 1].first, words[i + 1].second, h);
    emit(static_cast<int32_t>(h % buckets), 1.0f);
  }
  // char 3..5-grams over the compact string, prefixed "c<n>:"
  if (cg_weight == 0.0f) return;  // zero-weight grams must not emit (the COO
                                  // touched-tracking keys on nonzero counts)
  int64_t clen = static_cast<int64_t>(compact.size());
  for (int n = 3; n <= 5; ++n) {
    char prefix[4] = {'c', static_cast<char>('0' + n), ':', 0};
    for (int64_t i = 0; i + n <= clen; ++i) {
      uint64_t h = fnv1a(prefix, 3);
      h = fnv1a(buf + i, n, h);
      emit(static_cast<int32_t>(h % buckets), cg_weight);
    }
  }
}

extern "C" {

// ABI version probe: bindings require >= 2 for the weighted featurizer
// symbols; a stale .so then routes featurization to the Python fallback
// instead of silently hashing with a different weight.
int32_t ahrag_native_abi_version() { return 2; }

void hash_features(const char* text, int64_t len, int32_t buckets, float* out) {
  for_each_feature(text, len, buckets, 1.0f,
                   [&](int32_t b, float w) { out[b] += w; });
}

// Weighted variant: char 3..5-gram occurrences contribute `cg_weight`.
void hash_features_w(const char* text, int64_t len, int32_t buckets,
                     float cg_weight, float* out) {
  for_each_feature(text, len, buckets, cg_weight,
                   [&](int32_t b, float w) { out[b] += w; });
}

// Batched SPARSE featurization: documents are `data` sliced by `offsets`
// (n_docs+1 entries); emits COO triplets (row=doc, col=bucket, val=count)
// into rows/cols/vals (capacity `cap`), doc-major with ascending cols inside
// each doc. Threaded over documents. Returns total nnz, or -needed when `cap`
// is too small (caller re-allocates and retries).
//
// Why it exists: the dense [chunk, buckets] counts matrix costs more to
// allocate, fill and re-scan with np.nonzero than the hashing itself (profiled:
// ~0.9 ms/doc end-to-end dense vs ~0.04 ms/doc here), and the encoder ships
// COO triplets to the device anyway (models/encoder/hashed.py).
int64_t hash_features_coo_batch_w(const char* data, const int64_t* offsets,
                                  int32_t n_docs, int32_t buckets,
                                  float cg_weight, int32_t n_threads,
                                  int32_t* rows, int32_t* cols, float* vals,
                                  int64_t cap) {
  if (n_docs <= 0) return 0;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (nt > n_docs) nt = n_docs;

  struct Triplet { int32_t row, col; float val; };
  std::vector<std::vector<Triplet>> parts(nt);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      int32_t lo = static_cast<int32_t>(static_cast<int64_t>(n_docs) * t / nt);
      int32_t hi = static_cast<int32_t>(static_cast<int64_t>(n_docs) * (t + 1) / nt);
      auto& out = parts[t];
      std::vector<float> counts;                 // bucket -> count, reused
      counts.assign(buckets, 0.f);
      std::vector<int32_t> touched;              // buckets hit by this doc
      for (int32_t d = lo; d < hi; ++d) {
        touched.clear();
        for_each_feature(data + offsets[d], offsets[d + 1] - offsets[d],
                         buckets, cg_weight, [&](int32_t b, float w) {
                           if (counts[b] == 0.f) touched.push_back(b);
                           counts[b] += w;
                         });
        std::sort(touched.begin(), touched.end());
        for (int32_t b : touched) {
          out.push_back({d, b, counts[b]});
          counts[b] = 0.f;                       // reset for the next doc
        }
      }
    });
  }
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (auto& p : parts) total += static_cast<int64_t>(p.size());
  if (total > cap) return -total;
  int64_t w = 0;
  for (auto& p : parts) {
    for (auto& tr : p) {
      rows[w] = tr.row;
      cols[w] = tr.col;
      vals[w] = tr.val;
      ++w;
    }
  }
  return total;
}

// Exact top-k of q @ emb^T. q: [b, d], emb: [n, d] row-major.
// out_vals/out_idx: [b, k]. Blocked over rows for cache locality; ties break to
// the lowest index (matches the device kernels' determinism contract).
void exact_topk_f32(const float* q, const float* emb, int32_t b, int64_t n,
                    int32_t d, int32_t k, float* out_vals, int32_t* out_idx) {
  const float NEG = -1e30f;
  for (int32_t bi = 0; bi < b; ++bi) {
    const float* qv = q + static_cast<int64_t>(bi) * d;
    // (value, index) min-heap emulation via sorted insertion on a small array
    std::vector<float> vals(k, NEG);
    std::vector<int32_t> idx(k, 0);
    float worst = NEG;
    for (int64_t r = 0; r < n; ++r) {
      const float* ev = emb + r * d;
      float dot = 0.f;
      int32_t j = 0;
      for (; j + 4 <= d; j += 4) {
        dot += qv[j] * ev[j] + qv[j + 1] * ev[j + 1] + qv[j + 2] * ev[j + 2] +
               qv[j + 3] * ev[j + 3];
      }
      for (; j < d; ++j) dot += qv[j] * ev[j];
      if (dot <= worst) continue;  // strict: equal scores keep earlier index
      // insert into the sorted top-k (descending)
      int32_t pos = k - 1;
      while (pos > 0 && vals[pos - 1] < dot) {
        vals[pos] = vals[pos - 1];
        idx[pos] = idx[pos - 1];
        --pos;
      }
      vals[pos] = dot;
      idx[pos] = static_cast<int32_t>(r);
      worst = vals[k - 1];
    }
    std::memcpy(out_vals + static_cast<int64_t>(bi) * k, vals.data(),
                sizeof(float) * k);
    std::memcpy(out_idx + static_cast<int64_t>(bi) * k, idx.data(),
                sizeof(int32_t) * k);
  }
}

}  // extern "C"
