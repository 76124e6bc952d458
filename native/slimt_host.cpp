// slimt_host — native host-side hot paths for the JAX engine.
//
// The reference implements its entire host runtime in C++ (tokenizer
// via sentencepiece, hashing in Utils.hh:47-67, request/batcher in
// Request.cc/Batcher.cc). This library provides the measured hot
// paths natively for the Python runtime, loaded via ctypes:
//
//   - unigram-LM Viterbi segmentation (sentencepiece-compatible: NFC-
//     free normalization with whitespace escaping to U+2581, dummy
//     prefix, extra-whitespace removal, byte-range surface alignment)
//   - detokenization (ids -> text + per-token byte ranges)
//   - the boost-style hash fold used for cache keys and shortlist
//     checksums
//
// Exact behavioral parity with slimt_jax.text.vocabulary's pure
// Python backend is enforced by tests/test_native.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr const char* kSpace = "\xe2\x96\x81";  // U+2581 ▁
constexpr int kSpaceLen = 3;

enum PieceType : uint8_t {
  kNormal = 1,
  kUnknown = 2,
  kControl = 3,
  kUserDefined = 4,
  kUnused = 5,
  kByte = 6,
};

// sentencepiece precompiled charsmap: a darts-clone double-array trie
// mapping byte sequences to replacement strings in a NUL-separated
// pool (blob layout: u32 trie_size_bytes, trie units, pool). The
// traversal below follows darts-clone's commonPrefixSearch unit
// semantics: label = unit & 0x800000FF, has_leaf = bit 8, offset =
// (unit >> 10) << ((unit & 0x200) >> 6), child at node ^ offset ^ c,
// value unit at child slot 0 with bit 31 set.
struct Charsmap {
  std::vector<uint32_t> units;
  std::string pool;

  bool load(const char* blob, size_t len) {
    if (len < 4) return false;
    uint32_t trie_bytes;
    std::memcpy(&trie_bytes, blob, 4);
    if (4 + static_cast<size_t>(trie_bytes) > len || trie_bytes % 4 != 0) {
      return false;
    }
    units.resize(trie_bytes / 4);
    std::memcpy(units.data(), blob + 4, trie_bytes);
    pool.assign(blob + 4 + trie_bytes, len - 4 - trie_bytes);
    return !units.empty();
  }

  static inline uint32_t offset(uint32_t u) {
    return (u >> 10) << ((u & 0x200) >> 6);
  }

  // Longest match at s[0..maxlen); returns match byte length (0 if
  // none) and sets *value to the pool offset of the replacement.
  inline int longest(const char* s, int maxlen, uint32_t* value) const {
    const size_t n = units.size();
    uint32_t node_pos = offset(units[0]);
    int best = 0;
    for (int i = 0; i < maxlen; i++) {
      const uint32_t c = static_cast<unsigned char>(s[i]);
      const uint32_t next = node_pos ^ c;
      if (next >= n) break;
      const uint32_t unit = units[next];
      if ((unit & 0x800000FFU) != c) break;
      node_pos = next ^ offset(unit);
      if ((unit & 0x100U) && node_pos < n) {
        best = i + 1;
        *value = units[node_pos] & 0x7FFFFFFFU;
      }
    }
    return best;
  }

  inline const char* replacement(uint32_t value) const {
    return value < pool.size() ? pool.data() + value : "";
  }
};

struct Vocab {
  std::string blob;                   // concatenated piece bytes
  std::vector<uint32_t> offsets;      // n+1
  std::vector<float> scores;          // n
  std::vector<uint8_t> types;         // n
  uint32_t unk_id = 0;
  float unk_score = 0.0F;
  size_t max_piece_len = 1;
  std::unordered_map<std::string_view, uint32_t> ids;
  Charsmap charsmap;
  bool has_charsmap = false;
  int cap_mult = 1;  // worst-case normalized chars per input byte
  // Per first byte, a bitmask of piece byte-lengths that exist (bit
  // l-1 for length l in 1..32; bit 31 also means "lengths >= 32
  // exist"). Skips hash probes for candidate spans that cannot match.
  uint32_t len_mask[256] = {0};

  std::string_view piece(uint32_t id) const {
    return std::string_view(blob).substr(offsets[id],
                                         offsets[id + 1] - offsets[id]);
  }
};

// Length in bytes of the UTF-8 sequence starting at c; 1 for invalid.
inline int utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c & 0xE0) == 0xC0) return 2;
  if ((c & 0xF0) == 0xE0) return 3;
  if ((c & 0xF8) == 0xF0) return 4;
  return 1;
}

struct Normalized {
  std::string text;              // normalized utf8
  std::vector<uint32_t> align;   // per normalized byte: original byte pos

  void clear() {
    text.clear();
    align.clear();
  }
};

// Mirrors Vocabulary._normalize (python) / sentencepiece preprocessing:
// strip + collapse spaces, escape ' ' to U+2581, optional dummy prefix.
// Appends into `out` (caller clears; buffers are reused across calls
// on the batch path). `align_map` (optional) maps each position of
// `text` to an offset in the ORIGINAL input (the charsmap pass
// produces it); `orig_len` is the original input's byte length for
// the trailing alignment entry.
void normalize_into(const char* text, int len, bool add_dummy_prefix,
                    bool escape_ws, bool remove_extra_ws, Normalized& out,
                    const uint32_t* align_map = nullptr, int orig_len = -1) {
  if (orig_len < 0) orig_len = len;
  out.text.reserve(len + kSpaceLen);
  out.align.reserve(len + kSpaceLen);

  // Identify kept characters.
  int begin = 0;
  int end = len;
  if (remove_extra_ws) {
    while (begin < len && text[begin] == ' ') begin++;
    while (end > begin && text[end - 1] == ' ') end--;
  }

  bool first = true;
  bool prev_space = false;
  for (int i = begin; i < end;) {
    int n = utf8_len(static_cast<unsigned char>(text[i]));
    if (i + n > end) n = 1;
    bool is_space = (n == 1 && text[i] == ' ');
    if (is_space && remove_extra_ws && prev_space) {
      i += n;
      continue;
    }
    prev_space = is_space;
    const uint32_t pos =
        align_map ? align_map[i] : static_cast<uint32_t>(i);
    if (first && add_dummy_prefix) {
      const char* prefix = escape_ws ? kSpace : " ";
      int plen = escape_ws ? kSpaceLen : 1;
      for (int k = 0; k < plen; k++) {
        out.text.push_back(prefix[k]);
        out.align.push_back(pos);
      }
    }
    first = false;
    if (is_space && escape_ws) {
      for (int k = 0; k < kSpaceLen; k++) {
        out.text.push_back(kSpace[k]);
        out.align.push_back(pos);
      }
    } else {
      for (int k = 0; k < n; k++) {
        out.text.push_back(text[i + k]);
        out.align.push_back(pos);
      }
    }
    i += n;
  }
  out.align.push_back(static_cast<uint32_t>(orig_len));
}

// Reusable buffers for one segmentation call; a batch call reuses one
// Workspace per thread so short sentences don't pay per-call
// allocation churn.
struct Workspace {
  Normalized norm;
  std::string cm_text;             // charsmap output
  std::vector<uint32_t> cm_align;  // per charsmap-output byte: orig pos
  std::vector<int> starts;
  std::vector<float> best;
  std::vector<int> back_start;
  std::vector<uint32_t> back_id;
  std::vector<uint32_t> ids;
  std::vector<int> seg_start, seg_end;
};

// Apply the precompiled charsmap (sentencepiece
// Normalizer::NormalizePrefix semantics): at each position take the
// LONGEST trie match and emit its replacement, else copy one UTF-8
// character unchanged; every emitted byte aligns to the start of the
// consumed chunk.
void apply_charsmap(const Charsmap& cm, const char* text, int len,
                    std::string& out, std::vector<uint32_t>& align) {
  out.clear();
  align.clear();
  out.reserve(len);
  align.reserve(len);
  int i = 0;
  while (i < len) {
    uint32_t value = 0;
    int matched = cm.longest(text + i, len - i, &value);
    if (matched > 0) {
      for (const char* r = cm.replacement(value); *r != '\0'; r++) {
        out.push_back(*r);
        align.push_back(static_cast<uint32_t>(i));
      }
      i += matched;
    } else {
      int n = utf8_len(static_cast<unsigned char>(text[i]));
      if (i + n > len) n = 1;
      for (int k = 0; k < n; k++) {
        out.push_back(text[i + k]);
        align.push_back(static_cast<uint32_t>(i));
      }
      i += n;
    }
  }
}

// Viterbi segmentation over normalized UTF-8 *characters* (the lattice
// steps by codepoint like sentencepiece). Returns the token count, or
// -1 if `cap` is too small. Outputs: ids, and byte ranges into the
// ORIGINAL text (not tiled; adjacent unknowns merged).
int encode_core(const Vocab& v, const char* text, int len,
                bool add_dummy_prefix, bool escape_ws, bool remove_extra_ws,
                Workspace& ws, uint32_t* out_ids, uint32_t* out_begin,
                uint32_t* out_end, int cap) {
  ws.norm.clear();
  if (v.has_charsmap) {
    apply_charsmap(v.charsmap, text, len, ws.cm_text, ws.cm_align);
    normalize_into(ws.cm_text.data(), static_cast<int>(ws.cm_text.size()),
                   add_dummy_prefix, escape_ws, remove_extra_ws, ws.norm,
                   ws.cm_align.data(), len);
  } else {
    normalize_into(text, len, add_dummy_prefix, escape_ws, remove_extra_ws,
                   ws.norm);
  }
  const Normalized& norm = ws.norm;
  const std::string& s = norm.text;
  const int nbytes = static_cast<int>(s.size());
  if (nbytes == 0) return 0;

  // Character starts (in bytes) of the normalized string.
  std::vector<int>& starts = ws.starts;
  starts.clear();
  starts.reserve(nbytes + 1);
  for (int i = 0; i < nbytes;
       i += utf8_len(static_cast<unsigned char>(s[i]))) {
    starts.push_back(i);
  }
  starts.push_back(nbytes);
  const int nchars = static_cast<int>(starts.size()) - 1;

  constexpr float kNegInf = -1e30F;
  ws.best.assign(nchars + 1, kNegInf);
  ws.back_start.assign(nchars + 1, -1);
  ws.back_id.assign(nchars + 1, 0);
  std::vector<float>& best = ws.best;
  std::vector<int>& back_start = ws.back_start;
  std::vector<uint32_t>& back_id = ws.back_id;
  best[0] = 0.0F;

  const std::string_view sv(s);
  for (int start = 0; start < nchars; start++) {
    if (best[start] == kNegInf) continue;
    const float base = best[start];
    const uint32_t mask =
        v.len_mask[static_cast<unsigned char>(s[starts[start]])];
    bool found_single = false;
    for (int end = start + 1; end <= nchars; end++) {
      size_t span = static_cast<size_t>(starts[end] - starts[start]);
      if (span > v.max_piece_len) break;
      // Cheap length filter: no piece starting with this byte has this
      // byte length (bit 31 covers every length >= 32).
      if (!(mask & (1U << std::min<size_t>(span - 1, 31)))) continue;
      auto it = v.ids.find(sv.substr(starts[start], span));
      if (it == v.ids.end()) continue;
      uint8_t type = v.types[it->second];
      if (type == kControl || type == kUnknown || type == kUnused) continue;
      if (end == start + 1) found_single = true;
      float score = base + v.scores[it->second];
      if (score > best[end]) {
        best[end] = score;
        back_start[end] = start;
        back_id[end] = it->second;
      }
    }
    if (!found_single) {
      float score = base + v.unk_score;
      if (score > best[start + 1]) {
        best[start + 1] = score;
        back_start[start + 1] = start;
        back_id[start + 1] = v.unk_id;
      }
    }
  }

  // Backtrack (reversed), merging adjacent unknowns.
  std::vector<uint32_t>& ids = ws.ids;
  std::vector<int>& seg_start = ws.seg_start;
  std::vector<int>& seg_end = ws.seg_end;
  ids.clear();
  seg_start.clear();
  seg_end.clear();
  int pos = nchars;
  while (pos > 0) {
    int start = back_start[pos];
    ids.push_back(back_id[pos]);
    seg_start.push_back(start);
    seg_end.push_back(pos);
    pos = start;
  }
  std::reverse(ids.begin(), ids.end());
  std::reverse(seg_start.begin(), seg_start.end());
  std::reverse(seg_end.begin(), seg_end.end());

  int count = 0;
  for (size_t i = 0; i < ids.size(); i++) {
    if (count > 0 && ids[i] == v.unk_id && out_ids[count - 1] == v.unk_id &&
        seg_start[i] == static_cast<int>(/*prev end*/ seg_end[i - 1]) &&
        /*ensure merged only when contiguous*/ true) {
      // extend previous unknown token
      int nb = starts[seg_end[i]];
      out_end[count - 1] =
          (nb < static_cast<int>(norm.align.size())) ? norm.align[nb]
                                                     : norm.align.back();
      continue;
    }
    if (count >= cap) return -1;
    out_ids[count] = ids[i];
    int b0 = starts[seg_start[i]];
    int b1 = starts[seg_end[i]];
    out_begin[count] = norm.align[b0];
    out_end[count] = (b1 < static_cast<int>(norm.align.size()))
                         ? norm.align[b1]
                         : norm.align.back();
    count++;
  }
  return count;
}

}  // namespace

extern "C" {

void* slimt_vocab_create(const char* blob, const uint32_t* offsets,
                         const float* scores, const uint8_t* types,
                         uint32_t n, uint32_t unk_id) {
  auto* v = new Vocab();
  v->offsets.assign(offsets, offsets + n + 1);
  v->blob.assign(blob, offsets[n]);
  v->scores.assign(scores, scores + n);
  v->types.assign(types, types + n);
  v->unk_id = unk_id;
  float min_score = 0.0F;
  bool seen = false;
  for (uint32_t i = 0; i < n; i++) {
    std::string_view piece = v->piece(i);
    v->max_piece_len = std::max(v->max_piece_len, piece.size());
    v->ids.emplace(piece, i);
    if (!piece.empty()) {
      v->len_mask[static_cast<unsigned char>(piece[0])] |=
          1U << std::min<size_t>(piece.size() - 1, 31);
    }
    if (types[i] == kNormal || types[i] == kUserDefined) {
      if (!seen || scores[i] < min_score) min_score = scores[i];
      seen = true;
    }
  }
  v->unk_score = min_score - 10.0F;  // sentencepiece kUnkPenalty
  return v;
}

void slimt_vocab_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// Attach a precompiled charsmap (sentencepiece NormalizerSpec
// precompiled_charsmap blob). Returns 1 on success, 0 on a malformed
// blob (the vocab then behaves as if none was set).
int slimt_vocab_set_charsmap(void* handle, const char* blob, uint64_t len) {
  Vocab& v = *static_cast<Vocab*>(handle);
  v.has_charsmap = v.charsmap.load(blob, static_cast<size_t>(len));
  v.cap_mult = 1;
  if (v.has_charsmap) {
    // Worst-case normalized chars per input byte: a 1-byte key may
    // map to the pool's longest replacement (counted in chars).
    const std::string& pool = v.charsmap.pool;
    int chars = 0;
    for (size_t i = 0; i < pool.size(); i++) {
      if (pool[i] == '\0') {
        v.cap_mult = std::max(v.cap_mult, chars);
        chars = 0;
      } else if ((static_cast<unsigned char>(pool[i]) & 0xC0) != 0x80) {
        chars++;  // UTF-8 lead byte
      }
    }
    v.cap_mult = std::max(v.cap_mult, chars);
    v.cap_mult = std::max(v.cap_mult, 1);
  }
  return v.has_charsmap ? 1 : 0;
}

// Token-capacity scale factor callers must apply to byte-based
// bounds (1 without a charsmap).
int slimt_vocab_cap_multiplier(void* handle) {
  return static_cast<Vocab*>(handle)->cap_mult;
}

// Viterbi segmentation over normalized UTF-8 *characters* (the lattice
// steps by codepoint like sentencepiece). Returns the token count, or
// -1 if `cap` is too small. Outputs: ids, and byte ranges into the
// ORIGINAL text.
int slimt_vocab_encode(void* handle, const char* text, int len,
                       int add_dummy_prefix, int escape_ws,
                       int remove_extra_ws, uint32_t* out_ids,
                       uint32_t* out_begin, uint32_t* out_end, int cap) {
  Workspace ws;
  return encode_core(*static_cast<Vocab*>(handle), text, len,
                     add_dummy_prefix != 0, escape_ws != 0,
                     remove_extra_ws != 0, ws, out_ids, out_begin, out_end,
                     cap);
}

// Batched, multithreaded segmentation over n_sents concatenated
// sentences (offsets: n_sents+1 byte offsets into text). Emits flat
// per-token ids and *tiled* begins (token i of a sentence spans
// [begins[i], begins[i+1]) within that sentence, the last ending at
// out_ends[s] — the Vocabulary.encode_batch_begins contract), plus
// per-sentence token counts. out_ids/out_begins must hold
// cap_multiplier * offsets[n_sents] + n_sents entries (worst case:
// one token per normalized char plus the dummy prefix). Returns the total token count, or -1
// on capacity overflow (impossible at the documented sizing).
int64_t slimt_vocab_encode_batch(void* handle, const char* text,
                                 const uint64_t* offsets, int n_sents,
                                 int add_dummy_prefix, int escape_ws,
                                 int remove_extra_ws, int n_threads,
                                 uint32_t* out_ids, uint32_t* out_begins,
                                 uint32_t* out_counts, uint32_t* out_ends) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  if (n_sents <= 0) return 0;

  std::atomic<bool> failed(false);
  auto worker = [&](int lo, int hi) {
    Workspace ws;
    std::vector<uint32_t> ends;  // scratch, reused across sentences
    for (int s = lo; s < hi && !failed.load(std::memory_order_relaxed);
         s++) {
      const char* sent = text + offsets[s];
      const int len = static_cast<int>(offsets[s + 1] - offsets[s]);
      // Each sentence writes into its own disjoint slot; slots are
      // compacted after the join. Slot capacity m*len+1 bounds the
      // token count (<= normalized chars <= cap_mult*bytes + dummy
      // prefix).
      const int64_t slot = v.cap_mult * static_cast<int64_t>(offsets[s]) + s;
      const int slot_cap = v.cap_mult * len + 1;
      if (static_cast<size_t>(slot_cap) > ends.size()) {
        ends.resize(slot_cap);
      }
      int count =
          encode_core(v, sent, len, add_dummy_prefix != 0, escape_ws != 0,
                      remove_extra_ws != 0, ws, out_ids + slot,
                      out_begins + slot, ends.data(), slot_cap);
      if (count < 0) {
        failed.store(true, std::memory_order_relaxed);
        return;
      }
      out_counts[s] = static_cast<uint32_t>(count);
      // Tile ranges in place (Vocabulary._tile): begins[0] stays,
      // begins[i>0] = running end, out_ends[s] = final running end.
      uint32_t run_end = 0;
      uint32_t* begins = out_begins + slot;
      for (int i = 0; i < count; i++) {
        if (i > 0) begins[i] = run_end;
        run_end = std::max(run_end, ends[i]);
      }
      out_ends[s] = count > 0 ? run_end : 0;
    }
  };

  const int64_t total_bytes = static_cast<int64_t>(offsets[n_sents]);
  int threads = std::max(1, n_threads);
  threads = std::min<int64_t>(threads, n_sents);
  if (total_bytes < (64 << 10)) threads = 1;  // not worth spawning
  if (threads == 1) {
    worker(0, n_sents);
  } else {
    // Partition sentences into contiguous ranges of ~equal bytes.
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int lo = 0;
    for (int t = 0; t < threads && lo < n_sents; t++) {
      const uint64_t target =
          offsets[lo] + (offsets[n_sents] - offsets[lo]) / (threads - t);
      int hi = (t == threads - 1) ? n_sents : lo;
      while (hi < n_sents && offsets[hi] < target) hi++;
      if (hi == lo) hi++;
      pool.emplace_back(worker, lo, hi);
      lo = hi;
    }
    for (auto& th : pool) th.join();
  }
  if (failed.load()) return -1;

  // Compact slots left-to-right into flat arrays (safe: the compact
  // position never exceeds the slot position).
  int64_t out = 0;
  for (int s = 0; s < n_sents; s++) {
    const int64_t slot = v.cap_mult * static_cast<int64_t>(offsets[s]) + s;
    const int count = static_cast<int>(out_counts[s]);
    if (out != slot && count > 0) {
      std::memmove(out_ids + out, out_ids + slot, count * sizeof(uint32_t));
      std::memmove(out_begins + out, out_begins + slot,
                   count * sizeof(uint32_t));
    }
    out += count;
  }
  return out;
}

// Tokenize + hard-wrap + annotate a batch of lines in one call — the
// whole TextProcessor.process_batch hot loop
// (slimt/TextProcessor.cc:96-157 semantics) behind one GIL release.
// Sentence splitting stays on the Python side (it is cheap); this
// consumes per-line sentence byte spans and emits, per line, the
// wrapped segments (EOS appended) plus the AnnotatedText
// token_begin/gap contents exactly as repeated
// record_contiguous_sentence calls build them:
//   token_begin = [0] ++ per segment (tiled begins ++ [end, end]) ++ [L]
//   gap         = [0] ++ per segment (index after the first end)
//
// Lines parallelize across threads via caller-provided slot offset
// arrays (id_slot/tb_slot/gap_slot, each n_lines+1 int64 cumsums of
// the documented per-line bounds — see native.py ingest_lines); the
// call compacts slots into flat arrays before returning. seg_sizes is
// gap-slot-sized scratch; seg_bounds (total_segments+1) and seg_line
// (total_segments) are written compactly during the final pass.
// Returns the total segment count, or -1 on slot overflow (impossible
// at the documented sizing).
int64_t slimt_ingest_lines(
    void* handle, const char* lines, const uint64_t* line_offsets,
    int n_lines, const uint32_t* sent_begin, const uint32_t* sent_end,
    const int32_t* sent_counts, const int64_t* sent_starts,
    int wrap_length, uint32_t eos_id, int add_dummy_prefix, int escape_ws,
    int remove_extra_ws, int n_threads, const int64_t* id_slot,
    const int64_t* tb_slot, const int64_t* gap_slot, uint32_t* seg_ids,
    uint32_t* seg_sizes, uint32_t* tb, int32_t* tb_counts, uint32_t* gap,
    int32_t* gap_counts, int32_t* seg_counts, uint64_t* seg_bounds,
    int32_t* seg_line) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  if (n_lines <= 0) return 0;
  const int step = std::max(1, wrap_length - 1);

  std::atomic<bool> failed(false);
  auto worker = [&](int lo, int hi) {
    Workspace ws;
    std::vector<uint32_t> ids, begins, ends;
    for (int l = lo; l < hi && !failed.load(std::memory_order_relaxed);
         l++) {
      const char* line = lines + line_offsets[l];
      const uint32_t line_len =
          static_cast<uint32_t>(line_offsets[l + 1] - line_offsets[l]);
      uint32_t* ids_out = seg_ids + id_slot[l];
      uint32_t* tb_out = tb + tb_slot[l];
      uint32_t* gap_out = gap + gap_slot[l];
      uint32_t* sizes_out = seg_sizes + gap_slot[l];
      const int64_t id_cap = id_slot[l + 1] - id_slot[l];
      const int64_t tb_cap = tb_slot[l + 1] - tb_slot[l];
      const int64_t gap_cap = gap_slot[l + 1] - gap_slot[l];

      int64_t tb_len = 0, ids_len = 0;
      int32_t n_gaps = 0, n_segs = 0;
      tb_out[tb_len++] = 0;
      gap_out[n_gaps++] = 0;

      const int32_t n_sents = sent_counts[l];
      const int64_t sent0 = sent_starts[l];
      bool overflow = false;
      for (int32_t si = 0; si < n_sents && !overflow; si++) {
        const uint32_t b = sent_begin[sent0 + si];
        const int slen = static_cast<int>(sent_end[sent0 + si] - b);
        const int sent_cap = v.cap_mult * slen + 1;
        if (static_cast<size_t>(sent_cap) > ids.size()) {
          ids.resize(sent_cap);
          begins.resize(sent_cap);
          ends.resize(sent_cap);
        }
        int count = encode_core(v, line + b, slen, add_dummy_prefix != 0,
                                escape_ws != 0, remove_extra_ws != 0, ws,
                                ids.data(), begins.data(), ends.data(),
                                sent_cap);
        if (count < 0) {
          overflow = true;
          break;
        }
        if (count == 0) continue;  // empty sentence: no segment
        // Tile ranges (Vocabulary._tile) and shift into line offsets.
        uint32_t run_end = ends[0];
        begins[0] += b;
        for (int i = 1; i < count; i++) {
          begins[i] = run_end + b;
          if (ends[i] > run_end) run_end = ends[i];
        }
        const uint32_t final_end = run_end + b;
        // Hard-wrap at `step` tokens + EOS per wrapped segment
        // (TextProcessor._wrap).
        for (int off = 0; off < count; off += step) {
          const int hi_tok = std::min(off + step, count);
          const int n_tok = hi_tok - off;
          if (ids_len + n_tok + 1 > id_cap || tb_len + n_tok + 2 > tb_cap ||
              n_gaps + 1 > gap_cap) {
            overflow = true;
            break;
          }
          std::memcpy(ids_out + ids_len, ids.data() + off,
                      n_tok * sizeof(uint32_t));
          ids_len += n_tok;
          ids_out[ids_len++] = eos_id;
          const uint32_t chunk_end =
              (hi_tok < count) ? begins[hi_tok] : final_end;
          std::memcpy(tb_out + tb_len, begins.data() + off,
                      n_tok * sizeof(uint32_t));
          tb_len += n_tok;
          tb_out[tb_len++] = chunk_end;
          gap_out[n_gaps++] = static_cast<uint32_t>(tb_len);
          sizes_out[n_segs++] = static_cast<uint32_t>(n_tok + 1);
          tb_out[tb_len++] = chunk_end;
        }
      }
      if (overflow) {
        failed.store(true, std::memory_order_relaxed);
        return;
      }
      tb_out[tb_len++] = line_len;
      tb_counts[l] = static_cast<int32_t>(tb_len);
      gap_counts[l] = n_gaps;
      seg_counts[l] = n_segs;
    }
  };

  int threads = std::max(1, n_threads);
  threads = std::min(threads, n_lines);
  if (static_cast<int64_t>(line_offsets[n_lines]) < (64 << 10)) threads = 1;
  if (threads == 1) {
    worker(0, n_lines);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int lo = 0;
    for (int t = 0; t < threads && lo < n_lines; t++) {
      const uint64_t target =
          line_offsets[lo] +
          (line_offsets[n_lines] - line_offsets[lo]) / (threads - t);
      int hi = (t == threads - 1) ? n_lines : lo;
      while (hi < n_lines && line_offsets[hi] < target) hi++;
      if (hi == lo) hi++;
      pool.emplace_back(worker, lo, hi);
      lo = hi;
    }
    for (auto& th : pool) th.join();
  }
  if (failed.load()) return -1;

  // Compact slots left-to-right into flat arrays (compact positions
  // never exceed slot positions, so in-place memmove is safe) and
  // emit the clean seg_bounds/seg_line outputs.
  int64_t ids_pos = 0, tb_pos = 0, gap_pos = 0, seg_pos = 0;
  seg_bounds[0] = 0;
  for (int l = 0; l < n_lines; l++) {
    const int32_t n_segs = seg_counts[l];
    const uint32_t* sizes = seg_sizes + gap_slot[l];
    int64_t ids_len = 0;
    for (int32_t s = 0; s < n_segs; s++) {
      ids_len += sizes[s];
      seg_bounds[seg_pos + 1] = static_cast<uint64_t>(ids_pos + ids_len);
      seg_line[seg_pos] = l;
      seg_pos++;
    }
    if (ids_pos != id_slot[l] && ids_len > 0) {
      std::memmove(seg_ids + ids_pos, seg_ids + id_slot[l],
                   ids_len * sizeof(uint32_t));
    }
    if (tb_pos != tb_slot[l]) {
      std::memmove(tb + tb_pos, tb + tb_slot[l],
                   tb_counts[l] * sizeof(uint32_t));
    }
    if (gap_pos != gap_slot[l]) {
      std::memmove(gap + gap_pos, gap + gap_slot[l],
                   gap_counts[l] * sizeof(uint32_t));
    }
    ids_pos += ids_len;
    tb_pos += tb_counts[l];
    gap_pos += gap_counts[l];
  }
  return seg_pos;
}

// ids -> utf8 text + per-token byte ranges; control pieces surface
// empty, unknowns as sentencepiece's " ⁇ ". Returns text length in
// bytes, or -1 if caps are insufficient. out_begin may be null
// (begins are always the previous token's end; tokens are contiguous
// from 0).
static int decode_one(const Vocab& v, const uint32_t* ids, int n,
                      char* out_text, int text_cap, uint32_t* out_begin,
                      uint32_t* out_end) {
  static const std::string kUnkSurface = " \xe2\x81\x87 ";  // " ⁇ "
  int pos = 0;
  bool first_real = true;
  const uint32_t count = v.offsets.size() - 1;
  for (int i = 0; i < n; i++) {
    std::string surface;
    if (ids[i] < count) {
      uint8_t type = v.types[ids[i]];
      if (type == kControl || type == kByte) {
        // empty
      } else if (type == kUnknown) {
        // unk_surface participates in the leading-space strip like a
        // real piece (matches sentencepiece / the HF backend).
        surface = kUnkSurface;
        if (first_real) surface.erase(surface.begin());
        first_real = false;
      } else {
        std::string_view piece = v.piece(ids[i]);
        surface.reserve(piece.size());
        for (size_t k = 0; k < piece.size();) {
          if (piece.size() - k >= kSpaceLen &&
              std::memcmp(piece.data() + k, kSpace, kSpaceLen) == 0) {
            surface.push_back(' ');
            k += kSpaceLen;
          } else {
            surface.push_back(piece[k]);
            k += 1;
          }
        }
        if (first_real && !surface.empty() && surface[0] == ' ') {
          surface.erase(surface.begin());
        }
        first_real = false;
      }
    } else {
      surface = kUnkSurface;
      if (first_real) surface.erase(surface.begin());
      first_real = false;
    }
    if (pos + static_cast<int>(surface.size()) > text_cap) return -1;
    std::memcpy(out_text + pos, surface.data(), surface.size());
    if (out_begin != nullptr) out_begin[i] = static_cast<uint32_t>(pos);
    pos += static_cast<int>(surface.size());
    out_end[i] = static_cast<uint32_t>(pos);
  }
  return pos;
}

int slimt_vocab_decode(void* handle, const uint32_t* ids, int n,
                       char* out_text, int text_cap, uint32_t* out_begin,
                       uint32_t* out_end) {
  return decode_one(*static_cast<Vocab*>(handle), ids, n, out_text,
                    text_cap, out_begin, out_end);
}

// Batched decode over n_seqs sequences (flat ids + seq_offsets of
// n_seqs+1 entries), one library call per device batch instead of one
// per sentence. Token end offsets land in out_ends (flat, parallel to
// ids) relative to each sequence's own text; out_text_offsets
// (n_seqs+1) locates each sequence's text span in out_text. The
// word-start state resets per sequence, matching repeated
// slimt_vocab_decode calls exactly. Returns total bytes written, or
// -1 if text_cap is insufficient.
int slimt_vocab_decode_batch(void* handle, const uint32_t* ids,
                             const uint32_t* seq_offsets, int n_seqs,
                             char* out_text, int text_cap,
                             uint32_t* out_ends,
                             uint32_t* out_text_offsets) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  int pos = 0;
  for (int s = 0; s < n_seqs; s++) {
    out_text_offsets[s] = static_cast<uint32_t>(pos);
    const int begin = static_cast<int>(seq_offsets[s]);
    const int len = static_cast<int>(seq_offsets[s + 1]) - begin;
    int wrote = decode_one(v, ids + begin, len, out_text + pos,
                           text_cap - pos, nullptr, out_ends + begin);
    if (wrote < 0) return -1;
    pos += wrote;
  }
  out_text_offsets[n_seqs] = static_cast<uint32_t>(pos);
  return pos;
}

// Decode rows of a padded token matrix — the device result layout —
// in one call: row r uses ids[r*stride : r*stride + steps[r]]. Emits
// one flat text blob plus flat per-token end offsets, with
// out_text_off / out_ends_off (n_rows+1 each) locating each row's
// spans. Returns total text bytes, or -1 if text_cap is insufficient.
int64_t slimt_vocab_decode_padded(void* handle, const int32_t* ids,
                                  int64_t stride, const int32_t* steps,
                                  int n_rows, char* out_text,
                                  int64_t text_cap, uint32_t* out_ends,
                                  uint64_t* out_ends_off,
                                  uint64_t* out_text_off) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  int64_t pos = 0;
  int64_t ends_pos = 0;
  for (int r = 0; r < n_rows; r++) {
    out_text_off[r] = static_cast<uint64_t>(pos);
    out_ends_off[r] = static_cast<uint64_t>(ends_pos);
    const int n = steps[r];
    int wrote = decode_one(
        v, reinterpret_cast<const uint32_t*>(ids) + r * stride, n,
        out_text + pos, static_cast<int>(std::min<int64_t>(
                            text_cap - pos, INT32_MAX)),
        nullptr, out_ends + ends_pos);
    if (wrote < 0) return -1;
    pos += wrote;
    ends_pos += n;
  }
  out_text_off[n_rows] = static_cast<uint64_t>(pos);
  out_ends_off[n_rows] = static_cast<uint64_t>(ends_pos);
  return pos;
}

// Assemble per-line target text + annotation arrays from per-batch
// decode buffers — the Request._complete / append_sentence_raw loop
// (slimt/Request.cc:136-170) for a whole chunk in one call. Each
// line's sentences are located via (seg_batch, seg_row) into the
// pointer tables over per-batch slimt_vocab_decode_padded outputs;
// inter-sentence gap bytes come from the chunk's SOURCE annotation
// arrays (src_tb/src_gap, the ingest outputs). A line with
// seg_counts[l] < 0 is skipped (its outputs are empty) — the caller
// assembles it in Python (cache-hit content lives outside the batch
// buffers). Slot offset arrays partition the outputs per line;
// compaction happens before return, leaving out_text_off (n_lines+1)
// locating each line's text. Returns total text bytes, or -1 on slot
// overflow (impossible at the documented sizing).
int64_t slimt_assemble_lines(
    int n_lines, const char* src_blob, const uint64_t* src_line_off,
    const uint32_t* src_tb, const int64_t* src_tb_off,
    const uint32_t* src_gap, const int64_t* src_gap_off,
    const int32_t* seg_counts, const int64_t* seg_starts,
    const int32_t* seg_batch, const int32_t* seg_row,
    const char* const* batch_text, const uint64_t* const* batch_text_off,
    const uint32_t* const* batch_ends, const uint64_t* const* batch_ends_off,
    const int64_t* text_slot, const int64_t* tb_slot,
    const int64_t* gap_slot, char* out_text, uint32_t* out_tb,
    uint32_t* out_gap, int64_t* out_text_off, int32_t* tb_counts,
    int32_t* gap_counts) {
  for (int l = 0; l < n_lines; l++) {
    const int32_t n_segs = seg_counts[l];
    char* text = out_text + text_slot[l];
    uint32_t* tb = out_tb + tb_slot[l];
    uint32_t* gap = out_gap + gap_slot[l];
    const int64_t text_cap = text_slot[l + 1] - text_slot[l];
    const int64_t tb_cap = tb_slot[l + 1] - tb_slot[l];
    const int64_t gap_cap = gap_slot[l + 1] - gap_slot[l];
    int64_t text_len = 0, tb_len = 0;
    int32_t n_gaps = 0;
    if (n_segs < 0) {  // cache-hit line: assembled by the caller
      tb_counts[l] = 0;
      gap_counts[l] = 0;
      continue;
    }
    // AnnotatedText("") starts as token_begin=[0,0], gap=[0].
    tb[tb_len++] = 0;
    tb[tb_len++] = 0;
    gap[n_gaps++] = 0;
    const char* src_line = src_blob + src_line_off[l];
    const uint32_t* stb = src_tb + src_tb_off[l];
    const uint32_t* sgap = src_gap + src_gap_off[l];
    bool overflow = tb_cap < 2 || gap_cap < 1;
    for (int32_t si = 0; si < n_segs && !overflow; si++) {
      // append_ending_whitespace_data(source.gap_data(si))
      const uint32_t g0 = stb[sgap[si]];
      const uint32_t g1 = stb[sgap[si] + 1];
      const int32_t glen = static_cast<int32_t>(g1 - g0);
      const int32_t b = seg_batch[seg_starts[l] + si];
      const int32_t r = seg_row[seg_starts[l] + si];
      const uint64_t t0 = batch_text_off[b][r];
      const uint64_t t1 = batch_text_off[b][r + 1];
      const uint64_t e0 = batch_ends_off[b][r];
      const uint64_t e1 = batch_ends_off[b][r + 1];
      const int64_t n_tok = static_cast<int64_t>(e1 - e0);
      if (text_len + glen + static_cast<int64_t>(t1 - t0) > text_cap ||
          tb_len + n_tok + 1 > tb_cap || n_gaps + 1 > gap_cap) {
        overflow = true;
        break;
      }
      if (glen > 0) {
        std::memcpy(text + text_len, src_line + g0, glen);
        text_len += glen;
        tb[tb_len - 1] = static_cast<uint32_t>(text_len);
      }
      // append_sentence_raw(data, ends)
      const int64_t offset = text_len;
      std::memcpy(text + text_len, batch_text[b] + t0, t1 - t0);
      text_len += static_cast<int64_t>(t1 - t0);
      const uint32_t* ends = batch_ends[b] + e0;
      uint32_t last = 0;
      for (int64_t i = 0; i < n_tok; i++) {
        last = ends[i];
        tb[tb_len++] = static_cast<uint32_t>(offset) + last;
      }
      gap[n_gaps++] = static_cast<uint32_t>(tb_len - 1);
      tb[tb_len++] = static_cast<uint32_t>(offset) + last;
      if (si + 1 == n_segs) {
        // append_ending_whitespace_data(source.gap_data(n_segs))
        const uint32_t f0 = stb[sgap[n_segs]];
        const uint32_t f1 = stb[sgap[n_segs] + 1];
        const int32_t flen = static_cast<int32_t>(f1 - f0);
        if (flen > 0) {
          if (text_len + flen > text_cap) {
            overflow = true;
            break;
          }
          std::memcpy(text + text_len, src_line + f0, flen);
          text_len += flen;
          tb[tb_len - 1] = static_cast<uint32_t>(text_len);
        }
      }
    }
    if (overflow) return -1;
    tb_counts[l] = static_cast<int32_t>(tb_len);
    gap_counts[l] = n_gaps;
    out_text_off[l] = text_len;  // per-line length; offsets after compaction
  }

  // Compact slots into flat arrays; out_text_off becomes offsets.
  int64_t text_pos = 0, tb_pos = 0, gap_pos = 0;
  for (int l = 0; l < n_lines; l++) {
    const int64_t tlen = (seg_counts[l] < 0) ? 0 : out_text_off[l];
    if (text_pos != text_slot[l] && tlen > 0) {
      std::memmove(out_text + text_pos, out_text + text_slot[l], tlen);
    }
    if (tb_pos != tb_slot[l] && tb_counts[l] > 0) {
      std::memmove(out_tb + tb_pos, out_tb + tb_slot[l],
                   tb_counts[l] * sizeof(uint32_t));
    }
    if (gap_pos != gap_slot[l] && gap_counts[l] > 0) {
      std::memmove(out_gap + gap_pos, out_gap + gap_slot[l],
                   gap_counts[l] * sizeof(uint32_t));
    }
    out_text_off[l] = text_pos;
    text_pos += tlen;
    tb_pos += tb_counts[l];
    gap_pos += gap_counts[l];
  }
  out_text_off[n_lines] = text_pos;
  return text_pos;
}

// boost-style hash_combine fold with identity hash
// (reference slimt/Utils.hh:47-67).
uint64_t slimt_hash_words(uint64_t seed, const uint32_t* words, int n) {
  for (int i = 0; i < n; i++) {
    uint64_t value = words[i];
    seed ^= value + 0x9e3779b9ULL + (seed << 6) + (seed >> 2);
  }
  return seed;
}

uint64_t slimt_hash_u64(uint64_t seed, const uint64_t* words, int n) {
  for (int i = 0; i < n; i++) {
    seed ^= words[i] + 0x9e3779b9ULL + (seed << 6) + (seed >> 2);
  }
  return seed;
}

}  // extern "C"
