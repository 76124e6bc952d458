// Minimal sentencepiece shim for the crosscheck harness.
//
// The reference vendors browsermt sentencepiece as an
// (un-checked-out) submodule.  The harness feeds PRE-TOKENIZED ids,
// so text Encode/Decode is never exercised — but the reference's
// Vocabulary.cc, Shortlist.cc and Transformer.cc must compile
// verbatim.  This shim provides exactly the API surface
// /root/reference/slimt/Vocabulary.cc uses:
//   - SentencePieceProcessor::{LoadFromSerializedProto, Load, Encode,
//     Decode, pad_id, eos_id, GetPieceSize}
//   - SentencePieceText with pieces()/text()
//   - absl::string_view (aliased to std::string_view)
//
// LoadFromSerializedProto is a real (minimal) SPM ModelProto wire
// parser: pieces (string/score/type), TrainerSpec ids (fields 40-43),
// and NormalizerSpec (charsmap + flags).  Encode/Decode bridge to the
// repo's native Viterbi segmenter (native/slimt_host.cpp, linked into
// the harness) — NOT real sentencepiece (the vendored submodule is an
// empty checkout).  This is fine for what the harness text modes
// validate: with the tokenizer held IDENTICAL by construction on both
// sides, the differential isolates the reference's TextProcessor/
// Annotation semantics (wrap-at-128, EOS placement, byte-range
// bookkeeping) against slimt_jax's.  Tokenizer-level parity is
// separately covered by the 3-backend agreement tests in Python
// (native C++ / HF tokenizers / pure python).
#ifndef CROSSCHECK_SHIM_SENTENCEPIECE_PROCESSOR_H
#define CROSSCHECK_SHIM_SENTENCEPIECE_PROCESSOR_H

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <string_view>
#include <vector>

namespace absl {
using string_view = std::string_view;
}  // namespace absl

// Native Viterbi segmenter from the repo's host library
// (native/slimt_host.cpp), compiled into the harness.
extern "C" {
void* slimt_vocab_create(const char* blob, const uint32_t* offsets,
                         const float* scores, const uint8_t* types,
                         uint32_t n, uint32_t unk_id);
void slimt_vocab_destroy(void* handle);
int slimt_vocab_set_charsmap(void* handle, const char* blob, uint64_t len);
int slimt_vocab_cap_multiplier(void* handle);
int slimt_vocab_encode(void* handle, const char* text, int len,
                       int add_dummy_prefix, int escape_ws,
                       int remove_extra_ws, uint32_t* out_ids,
                       uint32_t* out_begin, uint32_t* out_end, int cap);
int slimt_vocab_decode(void* handle, const uint32_t* ids, int n,
                       char* out_text, int text_cap, uint32_t* out_begin,
                       uint32_t* out_end);
}

namespace sentencepiece {

class SentencePieceText {
 public:
  class Piece {
   public:
    int id() const { return id_; }
    uint32_t begin() const { return begin_; }
    uint32_t end() const { return end_; }
    int id_ = 0;
    uint32_t begin_ = 0;
    uint32_t end_ = 0;
  };

  const std::vector<Piece>& pieces() const { return pieces_; }
  const std::string& text() const { return text_; }

  std::vector<Piece> pieces_;
  std::string text_;
};

class SentencePieceProcessor {
 public:
  void LoadFromSerializedProto(absl::string_view serialized) {
    parse_model_proto(serialized);
  }

  void Load(const std::string& fpath) {
    FILE* f = std::fopen(fpath.c_str(), "rb");
    if (!f) {
      std::fprintf(stderr, "spm shim: cannot open %s\n", fpath.c_str());
      std::abort();
    }
    std::string buffer;
    char chunk[1 << 16];
    size_t n = 0;
    while ((n = std::fread(chunk, 1, sizeof(chunk), f)) > 0) {
      buffer.append(chunk, n);
    }
    std::fclose(f);
    parse_model_proto(buffer);
  }

  void Encode(absl::string_view line, SentencePieceText* out) const {
    out->pieces_.clear();
    out->text_.assign(line.data(), line.size());
    if (!handle_) {
      std::fprintf(stderr, "spm shim: Encode before Load\n");
      std::abort();
    }
    int cap = cap_mult_ * static_cast<int>(line.size()) + 8;
    std::vector<uint32_t> ids(cap), begin(cap), end(cap);
    int n = slimt_vocab_encode(
        handle_, line.data(), static_cast<int>(line.size()),
        add_dummy_prefix_, escape_ws_, remove_extra_ws_,
        ids.data(), begin.data(), end.data(), cap);
    if (n < 0) {
      std::fprintf(stderr, "spm shim: encode capacity overflow\n");
      std::abort();
    }
    out->pieces_.resize(n);
    for (int i = 0; i < n; i++) {
      out->pieces_[i].id_ = static_cast<int>(ids[i]);
      out->pieces_[i].begin_ = begin[i];
      out->pieces_[i].end_ = end[i];
    }
  }

  void Decode(const std::vector<int>& ids, SentencePieceText* out) const {
    out->pieces_.clear();
    out->text_.clear();
    if (!handle_ || ids.empty()) return;
    std::vector<uint32_t> uids(ids.begin(), ids.end());
    int cap = 16;
    for (int id : ids) {
      cap += static_cast<int>(piece_length(id)) + 1;
    }
    std::vector<char> text(cap);
    std::vector<uint32_t> begin(ids.size()), end(ids.size());
    int written = slimt_vocab_decode(
        handle_, uids.data(), static_cast<int>(uids.size()), text.data(),
        cap, begin.data(), end.data());
    if (written < 0) {
      std::fprintf(stderr, "spm shim: decode capacity overflow\n");
      std::abort();
    }
    out->text_.assign(text.data(), written);
    out->pieces_.resize(ids.size());
    for (size_t i = 0; i < ids.size(); i++) {
      out->pieces_[i].id_ = ids[i];
      out->pieces_[i].begin_ = begin[i];
      out->pieces_[i].end_ = end[i];
    }
  }

  int pad_id() const { return pad_id_; }
  int eos_id() const { return eos_id_; }
  int bos_id() const { return bos_id_; }
  int unk_id() const { return unk_id_; }
  int GetPieceSize() const { return piece_count_; }

 private:
  // --- SPM ModelProto wire-format subset ------------------------------
  static bool read_varint(const uint8_t*& p, const uint8_t* end,
                          uint64_t* value) {
    uint64_t result = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t byte = *p++;
      result |= static_cast<uint64_t>(byte & 0x7F) << shift;
      if (!(byte & 0x80)) {
        *value = result;
        return true;
      }
      shift += 7;
    }
    return false;
  }

  static bool skip_field(const uint8_t*& p, const uint8_t* end, uint64_t wire) {
    uint64_t tmp = 0;
    switch (wire) {
      case 0:  // varint
        return read_varint(p, end, &tmp);
      case 1:  // fixed64
        if (end - p < 8) return false;
        p += 8;
        return true;
      case 2:  // length-delimited
        if (!read_varint(p, end, &tmp) || static_cast<uint64_t>(end - p) < tmp)
          return false;
        p += tmp;
        return true;
      case 5:  // fixed32
        if (end - p < 4) return false;
        p += 4;
        return true;
      default:
        return false;
    }
  }

  size_t piece_length(int id) const {
    if (id < 0 || id >= piece_count_) return 0;
    return piece_offsets_[id + 1] - piece_offsets_[id];
  }

  // Parse one SentencePiece message: piece(1 string), score(2 float),
  // type(3 enum, default NORMAL=1).
  void parse_piece(const uint8_t* p, const uint8_t* end) {
    float score = 0.0F;
    uint8_t type = 1;
    std::string text;
    while (p < end) {
      uint64_t tag = 0;
      if (!read_varint(p, end, &tag)) break;
      uint64_t field = tag >> 3;
      uint64_t wire = tag & 0x7;
      if (field == 1 && wire == 2) {
        uint64_t len = 0;
        if (!read_varint(p, end, &len) ||
            static_cast<uint64_t>(end - p) < len)
          break;
        text.assign(reinterpret_cast<const char*>(p), len);
        p += len;
      } else if (field == 2 && wire == 5) {
        if (end - p < 4) break;
        std::memcpy(&score, p, 4);
        p += 4;
      } else if (field == 3 && wire == 0) {
        uint64_t v = 0;
        if (!read_varint(p, end, &v)) break;
        type = static_cast<uint8_t>(v);
      } else if (!skip_field(p, end, wire)) {
        break;
      }
    }
    piece_blob_ += text;
    piece_offsets_.push_back(static_cast<uint32_t>(piece_blob_.size()));
    piece_scores_.push_back(score);
    piece_types_.push_back(type);
  }

  void parse_normalizer_spec(const uint8_t* p, const uint8_t* end) {
    while (p < end) {
      uint64_t tag = 0;
      if (!read_varint(p, end, &tag)) return;
      uint64_t field = tag >> 3;
      uint64_t wire = tag & 0x7;
      if (field == 2 && wire == 2) {  // precompiled_charsmap
        uint64_t len = 0;
        if (!read_varint(p, end, &len) ||
            static_cast<uint64_t>(end - p) < len)
          return;
        charsmap_.assign(reinterpret_cast<const char*>(p), len);
        p += len;
      } else if (wire == 0 && field >= 3 && field <= 5) {
        uint64_t v = 0;
        if (!read_varint(p, end, &v)) return;
        if (field == 3) add_dummy_prefix_ = static_cast<int>(v);
        if (field == 4) remove_extra_ws_ = static_cast<int>(v);
        if (field == 5) escape_ws_ = static_cast<int>(v);
      } else if (!skip_field(p, end, wire)) {
        return;
      }
    }
  }

  void parse_trainer_spec(const uint8_t* p, const uint8_t* end) {
    while (p < end) {
      uint64_t tag = 0;
      if (!read_varint(p, end, &tag)) return;
      uint64_t field = tag >> 3;
      uint64_t wire = tag & 0x7;
      if (wire == 0 && field >= 40 && field <= 43) {
        uint64_t v = 0;
        if (!read_varint(p, end, &v)) return;
        int32_t value = static_cast<int32_t>(v);  // two's complement int32
        switch (field) {
          case 40: unk_id_ = value; break;
          case 41: bos_id_ = value; break;
          case 42: eos_id_ = value; break;
          case 43: pad_id_ = value; break;
        }
      } else if (!skip_field(p, end, wire)) {
        return;
      }
    }
  }

  void parse_model_proto(std::string_view serialized) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(serialized.data());
    const uint8_t* end = p + serialized.size();
    piece_count_ = 0;
    piece_blob_.clear();
    piece_offsets_.assign(1, 0);
    piece_scores_.clear();
    piece_types_.clear();
    while (p < end) {
      uint64_t tag = 0;
      if (!read_varint(p, end, &tag)) break;
      uint64_t field = tag >> 3;
      uint64_t wire = tag & 0x7;
      if (field == 1 && wire == 2) {  // repeated SentencePiece pieces
        uint64_t len = 0;
        if (!read_varint(p, end, &len) ||
            static_cast<uint64_t>(end - p) < len)
          break;
        parse_piece(p, p + len);
        p += len;
        ++piece_count_;
      } else if (field == 2 && wire == 2) {  // TrainerSpec
        uint64_t len = 0;
        if (!read_varint(p, end, &len) ||
            static_cast<uint64_t>(end - p) < len)
          break;
        parse_trainer_spec(p, p + len);
        p += len;
      } else if (field == 3 && wire == 2) {  // NormalizerSpec
        uint64_t len = 0;
        if (!read_varint(p, end, &len) ||
            static_cast<uint64_t>(end - p) < len)
          break;
        parse_normalizer_spec(p, p + len);
        p += len;
      } else if (!skip_field(p, end, wire)) {
        break;
      }
    }
    if (handle_) slimt_vocab_destroy(handle_);
    handle_ = slimt_vocab_create(
        piece_blob_.data(), piece_offsets_.data(), piece_scores_.data(),
        piece_types_.data(), static_cast<uint32_t>(piece_count_),
        static_cast<uint32_t>(unk_id_ < 0 ? 0 : unk_id_));
    cap_mult_ = 1;
    if (!charsmap_.empty() &&
        slimt_vocab_set_charsmap(handle_, charsmap_.data(),
                                 charsmap_.size())) {
      cap_mult_ = slimt_vocab_cap_multiplier(handle_);
    }
  }

 public:
  SentencePieceProcessor() = default;
  SentencePieceProcessor(const SentencePieceProcessor&) = delete;
  SentencePieceProcessor& operator=(const SentencePieceProcessor&) = delete;
  ~SentencePieceProcessor() {
    if (handle_) slimt_vocab_destroy(handle_);
  }

 private:
  int piece_count_ = 0;
  // sentencepiece TrainerSpec defaults.
  int unk_id_ = 0;
  int bos_id_ = 1;
  int eos_id_ = 2;
  int pad_id_ = -1;
  // NormalizerSpec (the repo writer's fields; spm defaults).
  std::string charsmap_;
  int add_dummy_prefix_ = 1;
  int remove_extra_ws_ = 1;
  int escape_ws_ = 1;
  // Piece table for the native segmenter bridge.
  std::string piece_blob_;
  std::vector<uint32_t> piece_offsets_{0};
  std::vector<float> piece_scores_;
  std::vector<uint8_t> piece_types_;
  void* handle_ = nullptr;
  int cap_mult_ = 1;
};

}  // namespace sentencepiece

#endif  // CROSSCHECK_SHIM_SENTENCEPIECE_PROCESSOR_H
