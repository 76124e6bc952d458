// Differential harness: drives the REFERENCE implementation's core
// objects (compiled verbatim from /root/reference/slimt) on
// pre-tokenized ids, so slimt_jax's outputs can be diffed against the
// actual C++ reference instead of a builder-written oracle.
//
// What is genuine reference code in this binary:
//   Aligned.cc Tensor.cc TensorOps.cc QMM.cc(+qmm/Ruy.inl.cc)
//   Modules.cc Transformer.cc Io.cc Input.cc Shortlist.cc Utils.cc
//   Vocabulary.cc
// (plus Regex.cc/Splitter.cc over the real libpcre2-8, and
// Annotation.cc/TextProcessor.cc for the --process mode)
// What is shimmed (see crosscheck/shims/): the un-checked-out
// third-party deps only — cblas.h (declarations; real system BLAS
// does the sgemm), ruy/ruy.h (exact scalar i8*i8->i32 GEMM,
// bit-identical to ruy's int32-destination semantics), pcre2.h
// (declarations; real libpcre2-8.so.0), and sentencepiece (ModelProto
// wire parser; Encode/Decode bridge to the repo's native Viterbi —
// identical on both sides of the differential by construction).
//
// This main replicates Model::forward + Model::decode
// (/root/reference/slimt/Model.cc:111-204) over those objects.
// Model.cc itself is the one core file not compiled (its constructor
// wires Package/mmap plumbing the harness does inline); the decode
// loop below intentionally mirrors Model.cc line-for-line (minus
// alignment bookkeeping) — a decode driver that deviated from the
// reference's would invalidate the differential.
//
// Protocol:
//   stdin:  one sentence per line, space-separated source token ids
//           (including the trailing EOS id, as TextProcessor-produced
//           segments carry).
//   stdout: one line per sentence, space-separated produced token ids
//           (including the trailing EOS when decode terminated on it).
//
// Usage:
//   slimt_ref_harness --model m.bin --vocab v.spm [--shortlist s.bin]
//       [--enc 6] [--dec 2] [--heads 8] [--ffn-depth 2]
//       [--limit-factor 1.5] [--batch 1]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <optional>
#include <sstream>
#include <string>
#include <vector>

#include "slimt/Input.hh"
#include "slimt/Io.hh"
#include "slimt/Shortlist.hh"
#include "slimt/Annotation.hh"
#include "slimt/Splitter.hh"
#include "slimt/TextProcessor.hh"
#include "slimt/Tensor.hh"
#include "slimt/TensorOps.hh"
#include "slimt/Transformer.hh"
#include "slimt/Types.hh"
#include "slimt/Vocabulary.hh"

namespace {

struct Args {
  std::string model;
  std::string vocab;
  std::string shortlist;
  size_t enc = 6;
  size_t dec = 2;
  size_t heads = 8;
  size_t ffn_depth = 2;
  float limit_factor = 1.5F;
  size_t batch = 1;
  bool dump_shortlist = false;  // print generated shortlists, skip decode
  std::string split;        // sentence|paragraph|wrapped: splitter mode
  std::string prefix_file;  // nonbreaking-prefix file for --split
  std::string process;      // TextProcessor mode (sentence|paragraph|wrapped_text)
  size_t wrap = 128;        // wrap_length for --process
};

// Text-pipeline differential: the reference TextProcessor::process
// (TextProcessor.cc:96-157) over the full reference Splitter +
// Annotation stack (the shim Vocabulary's Encode bridges to the
// repo's native Viterbi — held identical on both sides by
// construction, so this isolates wrap/EOS/annotation semantics).
// Reads all of stdin; prints per segment:
//   ids <space-separated token ids>
// then per sentence of the AnnotatedText:
//   sent <begin> <end> : <token begin:end pairs>
int run_process(const Args& args) {
  std::ostringstream buffer;
  buffer << std::cin.rdbuf();
  std::string text = buffer.str();

  slimt::io::MmapFile vocab_mmap(args.vocab);
  slimt::Vocabulary vocabulary(
      slimt::View{vocab_mmap.data(), vocab_mmap.size()});
  slimt::Aligned prefix_blob;
  if (!args.prefix_file.empty()) {
    FILE* f = std::fopen(args.prefix_file.c_str(), "rb");
    if (!f) return 2;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    prefix_blob = slimt::Aligned(64, size);
    if (std::fread(prefix_blob.data(), 1, size, f) !=
        static_cast<size_t>(size)) {
      std::fclose(f);
      return 2;
    }
    std::fclose(f);
  }
  slimt::TextProcessor processor(args.process, vocabulary, prefix_blob);
  auto [annotated, segments] = processor.process(std::move(text), args.wrap);

  for (const auto& segment : segments) {
    std::fputs("ids", stdout);
    for (uint32_t word : segment) std::fprintf(stdout, " %u", word);
    std::fputc('\n', stdout);
  }
  for (size_t s = 0; s < annotated.sentence_count(); s++) {
    slimt::Range sentence = annotated.annotation.sentence(s);
    std::fprintf(stdout, "sent %zu %zu :", sentence.begin, sentence.end);
    for (size_t w = 0; w < annotated.word_count(s); w++) {
      slimt::Range word = annotated.annotation.word(s, w);
      std::fprintf(stdout, " %zu:%zu", word.begin, word.end);
    }
    std::fputc('\n', stdout);
  }
  return 0;
}

// Splitter differential mode: runs the REFERENCE SentenceStream
// (Splitter.cc, genuine PCRE2 via libpcre2-8.so.0) over all of stdin
// and prints `begin end` byte offsets per sentence.
int run_split(const Args& args) {
  std::ostringstream buffer;
  buffer << std::cin.rdbuf();
  std::string text = buffer.str();

  slimt::Splitter splitter;
  if (!args.prefix_file.empty()) splitter.load(args.prefix_file);

  using Mode = slimt::SentenceStream::splitmode;
  Mode mode = Mode::OneSentencePerLine;
  if (args.split == "paragraph") mode = Mode::OneParagraphPerLine;
  else if (args.split == "wrapped") mode = Mode::WrappedText;
  else if (args.split != "sentence") {
    std::fprintf(stderr, "unknown split mode %s\n", args.split.c_str());
    return 2;
  }

  slimt::SentenceStream stream(text, splitter, mode);
  std::string_view sentence;
  while (stream >> sentence) {
    if (sentence.empty()) {
      // Paragraph-break marker (empty sentence between paragraphs,
      // Splitter.cc read_paragraph) — no byte range.
      std::fprintf(stdout, "para\n");
      continue;
    }
    size_t begin = sentence.data() - text.data();
    std::fprintf(stdout, "%zu %zu\n", begin, begin + sentence.size());
  }
  // Note: SentenceStream::status() is declared but never defined in
  // the reference (Splitter.hh:62) — check error_message() instead.
  if (!stream.error_message().empty()) {
    std::fprintf(stderr, "splitter error: %s\n",
                 stream.error_message().c_str());
    return 1;
  }
  return 0;
}

Args parse_args(int argc, char** argv) {
  Args args;
  auto need = [&](int i) {
    if (i + 1 >= argc) {
      std::fprintf(stderr, "missing value for %s\n", argv[i]);
      std::exit(2);
    }
    return std::string(argv[i + 1]);
  };
  for (int i = 1; i < argc; i += 2) {
    std::string flag = argv[i];
    if (flag == "--model") args.model = need(i);
    else if (flag == "--vocab") args.vocab = need(i);
    else if (flag == "--shortlist") args.shortlist = need(i);
    else if (flag == "--enc") args.enc = std::stoul(need(i));
    else if (flag == "--dec") args.dec = std::stoul(need(i));
    else if (flag == "--heads") args.heads = std::stoul(need(i));
    else if (flag == "--ffn-depth") args.ffn_depth = std::stoul(need(i));
    else if (flag == "--limit-factor") args.limit_factor = std::stof(need(i));
    else if (flag == "--batch") args.batch = std::stoul(need(i));
    else if (flag == "--dump-shortlist") {
      args.dump_shortlist = true;
      i -= 1;  // boolean flag, no value
    }
    else if (flag == "--split") args.split = need(i);
    else if (flag == "--prefix-file") args.prefix_file = need(i);
    else if (flag == "--process") args.process = need(i);
    else if (flag == "--wrap") args.wrap = std::stoul(need(i));
    else {
      std::fprintf(stderr, "unknown flag %s\n", flag.c_str());
      std::exit(2);
    }
  }
  if (!args.process.empty()) {
    if (args.vocab.empty()) {
      std::fprintf(stderr, "--process requires --vocab\n");
      std::exit(2);
    }
  } else if (args.split.empty() && (args.model.empty() || args.vocab.empty())) {
    std::fprintf(stderr, "--model and --vocab are required\n");
    std::exit(2);
  }
  return args;
}

// Replicates Model::decode (/root/reference/slimt/Model.cc:111-185),
// minus the alignment extraction, over reference Decoder/Shortlist
// objects.
slimt::Sentences decode(const slimt::Transformer& transformer,
                        const slimt::Vocabulary& vocabulary,
                        const std::optional<slimt::ShortlistGenerator>&
                            shortlist_generator,
                        const slimt::Tensor& encoder_out,
                        const slimt::Input& input) {
  using slimt::Sentences;
  using slimt::Tensor;
  using slimt::Words;

  size_t batch_size = encoder_out.dim(-3);
  size_t source_sequence_length = encoder_out.dim(-2);

  std::optional<Words> indices = std::nullopt;
  if (shortlist_generator) {
    slimt::Shortlist shortlist = shortlist_generator->generate(input.words());
    indices = shortlist.words();
  }

  std::vector<bool> complete(batch_size, false);
  uint32_t eos = vocabulary.eos_id();
  auto record = [eos, &complete](Words& step, Sentences& sentences) {
    size_t finished = 0;
    for (size_t i = 0; i < step.size(); i++) {
      if (!complete[i]) {
        complete[i] = (step[i] == eos);
        sentences[i].push_back(step[i]);
      }
      finished += static_cast<int>(complete[i]);
    }
    return sentences.size() - finished;
  };

  Sentences sentences(batch_size);

  const slimt::Decoder& decoder = transformer.decoder();
  Words previous_slice = {};
  std::vector<Tensor> states = decoder.start_states(batch_size);
  auto [logits, attn] =
      decoder.step(encoder_out, input.mask(), states, previous_slice, indices);

  if (indices) {
    previous_slice = slimt::greedy_sample_from_words(logits, vocabulary,
                                                     *indices, batch_size);
  } else {
    previous_slice = slimt::greedy_sample(logits, vocabulary, batch_size);
  }
  record(previous_slice, sentences);

  size_t remaining = sentences.size();
  size_t max_seq_length = input.limit_factor() * source_sequence_length;
  for (size_t i = 1; i < max_seq_length && remaining > 0; i++) {
    auto [step_logits, step_attn] = decoder.step(encoder_out, input.mask(),
                                                 states, previous_slice,
                                                 indices);
    if (indices) {
      previous_slice = slimt::greedy_sample_from_words(
          step_logits, vocabulary, *indices, batch_size);
    } else {
      previous_slice =
          slimt::greedy_sample(step_logits, vocabulary, batch_size);
    }
    remaining = record(previous_slice, sentences);
  }

  return sentences;
}

// Replicates Model::forward (/root/reference/slimt/Model.cc:187-204).
slimt::Sentences forward(const slimt::Transformer& transformer,
                         const slimt::Vocabulary& vocabulary,
                         const std::optional<slimt::ShortlistGenerator>&
                             shortlist_generator,
                         const slimt::Input& input) {
  slimt::Tensor word_embedding = slimt::index_select(
      transformer.embedding(), input.indices(), "word_embedding");
  slimt::transform_embedding(word_embedding);
  slimt::Tensor encoder_out =
      transformer.encoder().forward(word_embedding, input.mask());
  return decode(transformer, vocabulary, shortlist_generator, encoder_out,
                input);
}

void flush_batch(const slimt::Transformer& transformer,
                 const slimt::Vocabulary& vocabulary,
                 const std::optional<slimt::ShortlistGenerator>&
                     shortlist_generator,
                 const std::vector<std::vector<uint32_t>>& pending,
                 float limit_factor, bool dump_shortlist) {
  if (pending.empty()) return;
  if (dump_shortlist) {
    // Shortlist-generation differential mode: print the reference
    // ShortlistGenerator::generate result (Shortlist.cc:115-175) for
    // the batch's flattened words, one line per batch.
    slimt::Words words;
    for (const auto& sentence : pending)
      words.insert(words.end(), sentence.begin(), sentence.end());
    slimt::Shortlist shortlist = shortlist_generator->generate(words);
    const slimt::Words& generated = shortlist.words();
    for (size_t i = 0; i < generated.size(); i++) {
      if (i) std::fputc(' ', stdout);
      std::fprintf(stdout, "%u", generated[i]);
    }
    std::fputc('\n', stdout);
    return;
  }
  size_t max_len = 0;
  for (const auto& words : pending) max_len = std::max(max_len, words.size());

  // Mirrors Frontend.cc convert(): Input packed to [B, max_len] with
  // pad_id fill, then finalize() flips the mask to additive form
  // (/root/reference/slimt/Input.cc:49-63).
  slimt::Input input(pending.size(), max_len,
                     static_cast<uint32_t>(vocabulary.pad_id()), limit_factor);
  for (const auto& words : pending) input.add(words);
  input.finalize();

  slimt::Sentences sentences =
      forward(transformer, vocabulary, shortlist_generator, input);
  for (const auto& sentence : sentences) {
    for (size_t i = 0; i < sentence.size(); i++) {
      if (i) std::fputc(' ', stdout);
      std::fprintf(stdout, "%u", sentence[i]);
    }
    std::fputc('\n', stdout);
  }
}

}  // namespace

int main(int argc, char** argv) {
  Args args = parse_args(argc, argv);

  if (!args.split.empty()) return run_split(args);
  if (!args.process.empty()) return run_process(args);

  slimt::io::MmapFile model_mmap(args.model);
  slimt::io::MmapFile vocab_mmap(args.vocab);

  slimt::Vocabulary vocabulary(
      slimt::View{vocab_mmap.data(), vocab_mmap.size()});
  slimt::Transformer transformer(
      args.enc, args.dec, args.heads, args.ffn_depth,
      slimt::View{model_mmap.data(), model_mmap.size()});

  std::optional<slimt::io::MmapFile> shortlist_mmap;
  std::optional<slimt::ShortlistGenerator> shortlist_generator;
  if (!args.shortlist.empty()) {
    shortlist_mmap.emplace(args.shortlist);
    shortlist_generator.emplace(
        slimt::View{shortlist_mmap->data(), shortlist_mmap->size()},
        vocabulary, vocabulary);
  }

  std::vector<std::vector<uint32_t>> pending;
  std::string line;
  while (std::getline(std::cin, line)) {
    std::vector<uint32_t> words;
    std::istringstream stream(line);
    uint64_t id = 0;
    while (stream >> id) words.push_back(static_cast<uint32_t>(id));
    if (words.empty()) continue;
    pending.push_back(std::move(words));
    if (pending.size() == args.batch) {
      flush_batch(transformer, vocabulary, shortlist_generator, pending,
                  args.limit_factor, args.dump_shortlist);
      pending.clear();
    }
  }
  flush_batch(transformer, vocabulary, shortlist_generator, pending,
              args.limit_factor, args.dump_shortlist);
  return 0;
}
