// JNI binding for the slimt_jax engine — the counterpart of the
// reference's bindings/java/slimt.cpp (same Java-visible surface:
// io.github.jerinphilip.slimt.{Model,Service} natives), implemented
// over this framework's C embedding ABI (slimt_capi.h) instead of
// linking a C++ core: the JNI layer marshals Java objects, the C ABI
// hosts the engine.
//
// Surface (reference bindings/java/slimt.cpp:21-159):
//   Model.ncreate(Config, Package) -> long      handle
//   Model.ndestroy(long)
//   Service.ncreate(long cacheSize) -> long     handle
//   Service.ndestroy(long)
//   Service.ntranslate(long, long, String[], boolean html) -> String[]
//
// Config fields read: encoder_layers/decoder_layers/
// feed_forward_depth/num_heads (J), split_mode (Ljava/lang/String;).
// Package fields read: model/vocabulary/shortlist/ssplit
// (Ljava/lang/String;). Field names and signatures match the
// reference's Java classes so the same Java side loads either
// library.
//
// Every JNI call goes through SLIMT_JNI_CALL (jni_compat.h) — builds
// against the real <jni.h> when a JDK exists
// (-DSLIMT_JNI_USE_SYSTEM_JNI_H, C or C++ mode) or against the
// spec-ordered jni_compat.h otherwise; tested by a fake-JVM harness
// (native/jni_host.cpp) that implements the same table contract.

#include <cstdio>
#include <string>
#include <vector>

#include "jni_compat.h"
#include "slimt_capi.h"

namespace {

// JSON string escaping for paths/modes embedded in the model spec.
std::string json_escape(const std::string& raw) {
  std::string out;
  out.reserve(raw.size() + 8);
  for (unsigned char ch : raw) {
    switch (ch) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (ch < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", ch);
          out += buf;
        } else {
          out += static_cast<char>(ch);
        }
    }
  }
  return out;
}

void throw_runtime(JNIEnv* env, const char* message) {
  jclass runtime_error =
      SLIMT_JNI_CALL(env, FindClass, "java/lang/RuntimeException");
  if (runtime_error != nullptr) {
    SLIMT_JNI_CALL(env, ThrowNew, runtime_error, message);
  }
}

// A null GetFieldID leaves a NoSuchFieldError pending on the JVM, and
// issuing further JNI calls with an exception pending is undefined
// behavior per the JNI spec — so the field readers clear it, record
// the first missing field name in *missing, and the caller throws ONE
// RuntimeException after reading everything, instead of limping on
// with defaults.
std::string get_string_field(JNIEnv* env, jobject obj, jclass cls,
                             const char* name, const char** missing) {
  jfieldID field =
      SLIMT_JNI_CALL(env, GetFieldID, cls, name, "Ljava/lang/String;");
  if (field == nullptr) {
    SLIMT_JNI_CALL(env, ExceptionClear);
    if (*missing == nullptr) *missing = name;
    return "";
  }
  jstring jvalue =
      static_cast<jstring>(SLIMT_JNI_CALL(env, GetObjectField, obj, field));
  if (jvalue == nullptr) return "";  // null field value: optional path
  const char* utf8 = SLIMT_JNI_CALL(env, GetStringUTFChars, jvalue, nullptr);
  std::string value = utf8 != nullptr ? utf8 : "";
  if (utf8 != nullptr) {
    SLIMT_JNI_CALL(env, ReleaseStringUTFChars, jvalue, utf8);
  }
  SLIMT_JNI_CALL(env, DeleteLocalRef, jvalue);
  return value;
}

jlong get_long_field(JNIEnv* env, jobject obj, jclass cls, const char* name,
                     const char** missing) {
  jfieldID field = SLIMT_JNI_CALL(env, GetFieldID, cls, name, "J");
  if (field == nullptr) {
    SLIMT_JNI_CALL(env, ExceptionClear);
    if (*missing == nullptr) *missing = name;
    return 0;
  }
  return SLIMT_JNI_CALL(env, GetLongField, obj, field);
}

// Engine init is lazy (first ncreate) and idempotent; the JVM host
// may set SLIMT_JAX_PYTHONPATH when slimt_jax isn't installed
// site-wide — same contract as slimt_init(NULL).
bool ensure_engine(JNIEnv* env) {
  if (slimt_init(nullptr) == 0) return true;
  throw_runtime(env, slimt_last_error());
  return false;
}

}  // namespace

extern "C" {

#define SLIMT_JNI_EXPORT(cls, method) \
  JNICALL Java_io_github_jerinphilip_slimt_##cls##_##method

JNIEXPORT jlong SLIMT_JNI_EXPORT(Model, ncreate)(JNIEnv* env, jobject /*obj*/,
                                                 jobject jconfig,
                                                 jobject jpackage) {
  if (!ensure_engine(env)) return 0;

  const char* missing = nullptr;
  jclass config_cls = SLIMT_JNI_CALL(env, GetObjectClass, jconfig);
  jlong encoder_layers = get_long_field(env, jconfig, config_cls,
                                        "encoder_layers", &missing);
  jlong decoder_layers = get_long_field(env, jconfig, config_cls,
                                        "decoder_layers", &missing);
  jlong feed_forward_depth = get_long_field(env, jconfig, config_cls,
                                            "feed_forward_depth", &missing);
  jlong num_heads =
      get_long_field(env, jconfig, config_cls, "num_heads", &missing);
  std::string split_mode =
      get_string_field(env, jconfig, config_cls, "split_mode", &missing);

  jclass package_cls = SLIMT_JNI_CALL(env, GetObjectClass, jpackage);
  std::string model =
      get_string_field(env, jpackage, package_cls, "model", &missing);
  std::string vocabulary =
      get_string_field(env, jpackage, package_cls, "vocabulary", &missing);
  std::string shortlist =
      get_string_field(env, jpackage, package_cls, "shortlist", &missing);
  std::string ssplit =
      get_string_field(env, jpackage, package_cls, "ssplit", &missing);

  if (missing != nullptr) {
    std::string message =
        std::string("slimt JNI: missing Java field: ") + missing;
    throw_runtime(env, message.c_str());
    return 0;
  }

  std::string spec = "{\"preset\": \"tiny\"";
  spec += ", \"encoder_layers\": " + std::to_string(encoder_layers);
  spec += ", \"decoder_layers\": " + std::to_string(decoder_layers);
  spec += ", \"feed_forward_depth\": " + std::to_string(feed_forward_depth);
  spec += ", \"num_heads\": " + std::to_string(num_heads);
  if (!split_mode.empty()) {
    spec += ", \"split_mode\": \"" + json_escape(split_mode) + "\"";
  }
  spec += ", \"model\": \"" + json_escape(model) + "\"";
  spec += ", \"vocabulary\": \"" + json_escape(vocabulary) + "\"";
  if (!shortlist.empty()) {
    spec += ", \"shortlist\": \"" + json_escape(shortlist) + "\"";
  }
  if (!ssplit.empty()) {
    spec += ", \"ssplit\": \"" + json_escape(ssplit) + "\"";
  }
  spec += "}";

  long long handle = slimt_model_create(spec.c_str());
  if (handle == 0) {
    throw_runtime(env, slimt_last_error());
    return 0;
  }
  return static_cast<jlong>(handle);
}

JNIEXPORT void SLIMT_JNI_EXPORT(Model, ndestroy)(JNIEnv* /*env*/,
                                                 jobject /*obj*/,
                                                 jlong model_addr) {
  slimt_release(static_cast<long long>(model_addr));
}

JNIEXPORT jlong SLIMT_JNI_EXPORT(Service, ncreate)(JNIEnv* env,
                                                   jobject /*obj*/,
                                                   jlong cache_size) {
  if (!ensure_engine(env)) return 0;
  // The reference's JNI Service is the Blocking frontend
  // (bindings/java/slimt.cpp:12) — single worker semantics.
  long long handle =
      slimt_service_create(1, static_cast<int>(cache_size));
  if (handle == 0) {
    throw_runtime(env, slimt_last_error());
  }
  return static_cast<jlong>(handle);
}

JNIEXPORT void SLIMT_JNI_EXPORT(Service, ndestroy)(JNIEnv* /*env*/,
                                                   jobject /*obj*/,
                                                   jlong service_addr) {
  slimt_release(static_cast<long long>(service_addr));
}

JNIEXPORT jobjectArray SLIMT_JNI_EXPORT(Service, ntranslate)(
    JNIEnv* env, jobject /*obj*/, jlong service_addr, jlong model_addr,
    jobjectArray texts, jboolean html) {
  jsize length = SLIMT_JNI_CALL(env, GetArrayLength, texts);
  std::vector<std::string> sources;
  sources.reserve(static_cast<size_t>(length));
  for (jsize i = 0; i < length; ++i) {
    jobject jtext = SLIMT_JNI_CALL(env, GetObjectArrayElement, texts, i);
    if (jtext == nullptr) continue;  // reference skips null entries
    const char* utf8 = SLIMT_JNI_CALL(env, GetStringUTFChars,
                                      static_cast<jstring>(jtext), nullptr);
    if (utf8 != nullptr) {
      sources.emplace_back(utf8);
      SLIMT_JNI_CALL(env, ReleaseStringUTFChars, static_cast<jstring>(jtext),
                     utf8);
    }
    SLIMT_JNI_CALL(env, DeleteLocalRef, jtext);
  }

  std::vector<const char*> pointers;
  pointers.reserve(sources.size());
  for (const std::string& source : sources) pointers.push_back(source.c_str());

  char** targets = slimt_translate(
      static_cast<long long>(service_addr), static_cast<long long>(model_addr),
      pointers.data(), static_cast<int>(pointers.size()), html != JNI_FALSE,
      /*as_json=*/0);
  if (targets == nullptr) {
    throw_runtime(env, slimt_last_error());
    return nullptr;
  }

  jclass string_cls = SLIMT_JNI_CALL(env, FindClass, "java/lang/String");
  jobjectArray jtargets = SLIMT_JNI_CALL(
      env, NewObjectArray, static_cast<jsize>(sources.size()), string_cls,
      nullptr);
  for (size_t i = 0; i < sources.size() && targets[i] != nullptr; ++i) {
    jstring jtarget = SLIMT_JNI_CALL(env, NewStringUTF, targets[i]);
    SLIMT_JNI_CALL(env, SetObjectArrayElement, jtargets,
                   static_cast<jsize>(i), jtarget);
    SLIMT_JNI_CALL(env, DeleteLocalRef, jtarget);
  }
  slimt_free_strings(targets);
  return jtargets;
}

#undef SLIMT_JNI_EXPORT

}  // extern "C"
