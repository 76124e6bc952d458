/* C embedding ABI for the slimt_jax translation engine.
 *
 * Link against libslimt_capi.so (which embeds CPython and the JAX
 * engine) to drive translation in-process from C, C++, JNI, or any
 * FFI — the counterpart of the reference's pybind11/JNI bindings
 * (bindings/python/slimt.cpp, bindings/java/slimt.cpp).
 *
 * Typical use:
 *   slimt_init(NULL);
 *   long long svc = slimt_service_create(1, 1024);
 *   long long model = slimt_model_create("{\"preset\":\"tiny\", ...}");
 *   const char* texts[] = {"Hello world."};
 *   char** out = slimt_translate(svc, model, texts, 1, 0, 0);
 *   ...
 *   slimt_free_strings(out);
 *   slimt_shutdown();
 *
 * All functions are thread-safe after slimt_init(). On failure they
 * return 0/NULL; slimt_last_error() describes the failure
 * (thread-local storage).
 */
#ifndef SLIMT_CAPI_H_
#define SLIMT_CAPI_H_

#ifdef __cplusplus
extern "C" {
#endif

/* Initialize the embedded interpreter and engine. Idempotent; safe in
 * processes that already host Python. extra_pythonpath (optional,
 * may be NULL) is prepended to sys.path so slimt_jax can be found
 * when it is not installed site-wide; SLIMT_JAX_PYTHONPATH env works
 * too. Returns 0 on success. */
int slimt_init(const char* extra_pythonpath);

/* Create a translation service (async workers + cache), mirroring the
 * reference Service(workers, cache_size). Returns a handle, 0 on
 * error. */
long long slimt_service_create(int workers, int cache_size);

/* Create a model from a JSON spec: {"preset": "tiny"|"base"|"nano",
 * optional "encoder_layers"/"decoder_layers"/"num_heads"/"split_mode"
 * overrides, "model": path, "vocabulary": path, optional "shortlist",
 * "ssplit"}. Returns a handle, 0 on error. */
long long slimt_model_create(const char* spec_json);

/* Translate `count` UTF-8 texts. html!=0 runs HTML markup transfer;
 * as_json!=0 returns full Response JSON (source/target annotations +
 * alignments) instead of plain target text. Returns a NULL-terminated
 * array of `count` malloc'd strings, or NULL on error. */
char** slimt_translate(long long service, long long model,
                       const char* const* texts, int count, int html,
                       int as_json);

/* Two-leg pivot translation (first: src->pivot, second: pivot->tgt),
 * alignment-remapped like the reference Response::combine. */
char** slimt_pivot(long long service, long long first, long long second,
                   const char* const* texts, int count, int html,
                   int as_json);

/* Free an array returned by slimt_translate/slimt_pivot. */
void slimt_free_strings(char** strings);

/* Release a service or model handle (closes services). */
void slimt_release(long long handle);

/* Close every live handle. The interpreter stays resident. */
int slimt_shutdown(void);

/* Message for the most recent failure on this thread. */
const char* slimt_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* SLIMT_CAPI_H_ */
