// Java embedding example for slimt-jax.
//
// The reference project ships JNI bindings (reference
// bindings/java/slimt.cpp) so Android apps can call the C++ engine
// in-process. slimt-jax's engine is a Python/JAX process that owns the
// GPU, so cross-language embedding goes over the localhost HTTP/JSON
// surface instead (slimt_jax/server.py) — same Service semantics
// (translate, pivot, HTML passthrough, model registry, health).
//
// Run the server:
//   python -m slimt_jax.server --root <model-dir> --port 18931
// Then:
//   javac examples/JavaClient.java && java -cp examples JavaClient
//
// Uses only java.net.http (JDK 11+); no third-party JSON library —
// requests are built with a minimal escaper and responses printed raw.
//
// STATUS: requires a JDK, which does not exist in the build/test
// environment — this file has never been compiled or executed there
// (tests/test_bindings.py compiles+runs it only when `javac` is
// found). The TESTED Java-embedding story is the JNI binding
// (native/slimt_jni.cpp, driven by the fake-JVM harness in
// tests/test_jni.py) and the C ABI / HTTP clients.

import java.net.URI;
import java.net.http.HttpClient;
import java.net.http.HttpRequest;
import java.net.http.HttpResponse;

public class JavaClient {
    // Overridable: JavaClient [baseUrl] [text]
    static String BASE = "http://127.0.0.1:18931";

    static String jsonEscape(String s) {
        StringBuilder b = new StringBuilder();
        for (char c : s.toCharArray()) {
            switch (c) {
                case '"': b.append("\\\""); break;
                case '\\': b.append("\\\\"); break;
                case '\n': b.append("\\n"); break;
                case '\r': b.append("\\r"); break;
                case '\t': b.append("\\t"); break;
                default:
                    if (c < 0x20) b.append(String.format("\\u%04x", (int) c));
                    else b.append(c);
            }
        }
        return b.toString();
    }

    static String post(HttpClient client, String path, String body)
            throws Exception {
        HttpRequest request = HttpRequest.newBuilder()
                .uri(URI.create(BASE + path))
                .header("Content-Type", "application/json")
                .POST(HttpRequest.BodyPublishers.ofString(body))
                .build();
        HttpResponse<String> response =
                client.send(request, HttpResponse.BodyHandlers.ofString());
        if (response.statusCode() != 200) {
            throw new RuntimeException(
                    "HTTP " + response.statusCode() + ": " + response.body());
        }
        return response.body();
    }

    public static void main(String[] args) throws Exception {
        if (args.length > 0) BASE = args[0];
        HttpClient client = HttpClient.newHttpClient();

        // Liveness + device health (reference has no equivalent; the
        // accelerator serving tier needs it).
        HttpResponse<String> health = client.send(
                HttpRequest.newBuilder(URI.create(BASE + "/health")).build(),
                HttpResponse.BodyHandlers.ofString());
        System.out.println("health: " + health.body());

        // Blocking translate — mirrors Service.translate(model, [text]).
        String text = args.length > 1 ? args[1] : "Hello world. How are you?";
        String body = "{\"text\": \"" + jsonEscape(text) + "\"}";
        System.out.println("translate: " + post(client, "/translate", body));

        // HTML passthrough — markup is re-applied to the translation.
        String html = "{\"text\": \"<b>Hello</b> world\", \"html\": true}";
        System.out.println("html: " + post(client, "/translate", html));
    }
}
