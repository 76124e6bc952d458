// Embed the slimt_jax engine in a C++ host via the C ABI — the
// in-process counterpart of examples/JavaClient.java (which uses the
// HTTP surface). Mirrors what the reference's JNI host does
// (bindings/java/slimt.cpp): build a Model from artifact paths,
// translate a couple of sentences, print the targets.
//
// Build & run (see native/Makefile):
//   make -C native libslimt_capi.so
//   g++ -std=c++17 examples/embed_capi.cc -Inative -Lnative \
//       -lslimt_capi -o /tmp/embed_capi
//   ./embed_capi <package_dir> [pythonpath]
// where <package_dir> holds model.bin / vocab.spm / shortlist.bin
// (e.g. from `python -m slimt_jax synth --out <package_dir>`).

#include <cstdio>
#include <string>

#include "slimt_capi.h"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <package_dir> [pythonpath]\n", argv[0]);
    return 2;
  }
  const std::string root = argv[1];
  const char* pythonpath = argc > 2 ? argv[2] : nullptr;

  if (slimt_init(pythonpath) != 0) {
    std::fprintf(stderr, "init failed: %s\n", slimt_last_error());
    return 1;
  }

  // Config-field overrides (encoder_layers/decoder_layers/num_heads/
  // split_mode) are accepted alongside "preset" — the JNI ncreate
  // input set — but the synth package matches the preset as-is.
  const std::string spec = std::string("{\"preset\": \"tiny\",") +
                           "\"model\": \"" + root + "/model.bin\"," +
                           "\"vocabulary\": \"" + root + "/vocab.spm\"," +
                           "\"shortlist\": \"" + root + "/shortlist.bin\"}";

  long long service = slimt_service_create(/*workers=*/1,
                                           /*cache_size=*/1024);
  long long model = slimt_model_create(spec.c_str());
  if (service == 0 || model == 0) {
    std::fprintf(stderr, "create failed: %s\n", slimt_last_error());
    return 1;
  }

  const char* texts[] = {"hello world .", "the cat sat ."};
  char** outputs = slimt_translate(service, model, texts, 2, /*html=*/0,
                                   /*as_json=*/0);
  if (outputs == nullptr) {
    std::fprintf(stderr, "translate failed: %s\n", slimt_last_error());
    return 1;
  }
  for (int i = 0; outputs[i] != nullptr; ++i)
    std::printf("%d\t%s\n", i, outputs[i]);
  slimt_free_strings(outputs);

  // JSON form carries annotations + alignments.
  char** as_json = slimt_translate(service, model, texts, 1, 0, 1);
  if (as_json == nullptr) {
    std::fprintf(stderr, "translate(json) failed: %s\n", slimt_last_error());
    return 1;
  }
  std::printf("json\t%.60s...\n", as_json[0]);
  slimt_free_strings(as_json);

  slimt_release(model);
  slimt_release(service);
  slimt_shutdown();
  std::printf("ok\n");
  return 0;
}
