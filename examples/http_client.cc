// Native HTTP client for the slimt-jax serving endpoint.
//
// The reference project ships JNI bindings (reference
// bindings/java/slimt.cpp) so JVM/Android apps can call the engine
// in-process.  slimt-jax's engine is a Python/JAX process that owns
// the GPU, so cross-language embedding has two supported surfaces:
//   - in-process: the C ABI (native/slimt_capi.h, embedded CPython —
//     see examples/embed_capi.cc), which a JNI wrapper would link;
//   - out-of-process: the localhost HTTP/JSON endpoint
//     (slimt_jax/server.py) this client exercises.
// This file is the compiled-and-tested counterpart of the reference's
// JNI smoke path (tests/test_http_client.py builds and runs it
// against a live server; examples/JavaClient.java shows the same
// calls from Java for environments with a JDK).
//
// Plain POSIX sockets + a minimal JSON string escaper/extractor — no
// third-party dependencies, mirroring how a mobile/embedded host
// would call the service.
//
// Usage: http_client <host> <port> [text...]
//   GETs /health, then POSTs each text to /translate and prints the
//   "target" field, one per line. Exits non-zero on any failure.

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

int connect_to(const char* host, const char* port) {
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* result = nullptr;
  if (getaddrinfo(host, port, &hints, &result) != 0) return -1;
  int fd = -1;
  for (addrinfo* rp = result; rp; rp = rp->ai_next) {
    fd = socket(rp->ai_family, rp->ai_socktype, rp->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, rp->ai_addr, rp->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(result);
  return fd;
}

bool send_all(int fd, const std::string& data) {
  size_t sent = 0;
  while (sent < data.size()) {
    ssize_t n = write(fd, data.data() + sent, data.size() - sent);
    if (n <= 0) return false;
    sent += n;
  }
  return true;
}

std::string recv_all(int fd) {
  std::string out;
  char buf[4096];
  ssize_t n = 0;
  while ((n = read(fd, buf, sizeof(buf))) > 0) out.append(buf, n);
  return out;
}

// One HTTP/1.0 request (connection closes after the response, so no
// chunked parsing needed); returns the response body, or empty + -1
// status on transport failure.
std::string request(const char* host, const char* port,
                    const std::string& method, const std::string& path,
                    const std::string& body, int* status) {
  *status = -1;
  int fd = connect_to(host, port);
  if (fd < 0) return "";
  std::string msg = method + " " + path + " HTTP/1.0\r\n";
  msg += "Host: " + std::string(host) + "\r\n";
  if (!body.empty()) {
    msg += "Content-Type: application/json\r\n";
    msg += "Content-Length: " + std::to_string(body.size()) + "\r\n";
  }
  msg += "\r\n" + body;
  std::string response;
  if (send_all(fd, msg)) response = recv_all(fd);
  close(fd);

  if (response.compare(0, 5, "HTTP/") != 0) return "";
  size_t space = response.find(' ');
  if (space == std::string::npos) return "";
  *status = std::atoi(response.c_str() + space + 1);
  size_t sep = response.find("\r\n\r\n");
  return sep == std::string::npos ? "" : response.substr(sep + 4);
}

std::string json_escape(const std::string& text) {
  std::string out;
  for (unsigned char c : text) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char hex[8];
          std::snprintf(hex, sizeof(hex), "\\u%04x", c);
          out += hex;
        } else {
          out += static_cast<char>(c);
        }
    }
  }
  return out;
}

// Extract a top-level string field from a JSON object: finds
// "key":"..." and unescapes. Sufficient for the server's flat
// responses; a real host would use a JSON library.
bool json_string_field(const std::string& body, const std::string& key,
                       std::string* value) {
  std::string needle = "\"" + key + "\"";
  size_t pos = body.find(needle);
  if (pos == std::string::npos) return false;
  pos = body.find(':', pos + needle.size());
  if (pos == std::string::npos) return false;
  pos = body.find('"', pos);
  if (pos == std::string::npos) return false;
  ++pos;
  value->clear();
  while (pos < body.size() && body[pos] != '"') {
    char c = body[pos++];
    if (c == '\\' && pos < body.size()) {
      char esc = body[pos++];
      switch (esc) {
        case 'n': value->push_back('\n'); break;
        case 'r': value->push_back('\r'); break;
        case 't': value->push_back('\t'); break;
        case 'u': {
          if (pos + 4 <= body.size()) {
            unsigned code = std::strtoul(body.substr(pos, 4).c_str(), nullptr, 16);
            pos += 4;
            if (code < 0x80) {
              value->push_back(static_cast<char>(code));
            } else {  // 2-byte UTF-8 is enough for the escaped range
              value->push_back(static_cast<char>(0xC0 | (code >> 6)));
              value->push_back(static_cast<char>(0x80 | (code & 0x3F)));
            }
          }
          break;
        }
        default: value->push_back(esc);
      }
    } else {
      value->push_back(c);
    }
  }
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <host> <port> [text...]\n", argv[0]);
    return 2;
  }
  const char* host = argv[1];
  const char* port = argv[2];

  int status = 0;
  std::string body = request(host, port, "GET", "/health", "", &status);
  if (status != 200) {
    std::fprintf(stderr, "health check failed: status %d\n", status);
    return 1;
  }
  std::string health;
  if (!json_string_field(body, "status", &health) || health != "ok") {
    std::fprintf(stderr, "health not ok: %s\n", body.c_str());
    return 1;
  }

  for (int i = 3; i < argc; i++) {
    std::string payload = "{\"text\":\"" + json_escape(argv[i]) + "\"}";
    body = request(host, port, "POST", "/translate", payload, &status);
    if (status != 200) {
      std::fprintf(stderr, "translate failed: status %d body %s\n", status,
                   body.c_str());
      return 1;
    }
    std::string target;
    if (!json_string_field(body, "target", &target)) {
      std::fprintf(stderr, "no target in response: %s\n", body.c_str());
      return 1;
    }
    std::printf("%s\n", target.c_str());
  }
  return 0;
}
