// fastdnn-io — native host-side CLI over the fastdnn_io data plane.
//
// The reference ships a native executable for its host data path
// (/root/reference/src/cpp/dnn.cc:20-84); scoring here happens on the GPU
// via the Python engine, so the native CLI covers the pure host-side jobs:
// inspecting and converting model/feature files without starting a Python
// process.
//
//   fastdnn-io info MODEL.bin              print topology + parameter count
//   fastdnn-io finfo FEATURES.bin          print frame count / dim / stats
//   fastdnn-io text2bin FEATS.txt OUT.bin  Kaldi text features -> binary
//                                          (first utterance, like
//                                          BatchData.loadFromText)
//   fastdnn-io dump FEATURES.bin [N]       print the first N frames as text
//   fastdnn-io score HOST:PORT FEATS.bin [OUT.bin [BIN|TXT]]
//                                          score end-to-end against a running
//                                          fastdnn-serve instance (the FDN1
//                                          wire protocol, cli/serve.py) — the
//                                          native analog of the reference's
//                                          scoring executable (dnn.cc:20-84),
//                                          with the DNN math on the GPU
//
// Build: make -C native (produces native/fastdnn-io next to the .so).

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void* fd_read_model(const char* path);
int32_t fd_model_layer_count(void* h);
int32_t fd_model_input_dim(void* h, int32_t i);
int32_t fd_model_output_dim(void* h, int32_t i);
void fd_model_free(void* h);
int32_t fd_read_features(const char* path, float** data, int32_t* frames, int32_t* dim);
int32_t fd_write_features(const char* path, const float* data, int32_t frames, int32_t dim);
void fd_buffer_free(float* p);
void* fd_read_features_text(const char* path);
int32_t fd_ftext_count(void* h);
const char* fd_ftext_id(void* h, int32_t i);
int32_t fd_ftext_frames(void* h, int32_t i);
int32_t fd_ftext_dim(void* h, int32_t i);
const float* fd_ftext_data(void* h, int32_t i);
void fd_ftext_free(void* h);
}

static int cmd_info(const char* path) {
  void* h = fd_read_model(path);
  if (!h) {
    std::fprintf(stderr, "error: cannot parse model file %s\n", path);
    return 2;
  }
  const int32_t layers = fd_model_layer_count(h);
  int64_t params = 0;
  std::printf("layers  = %d\n", layers);
  std::printf("topology= %d", fd_model_input_dim(h, 0));
  for (int32_t i = 0; i < layers; ++i) {
    std::printf("-%d", fd_model_output_dim(h, i));
    params += int64_t(fd_model_input_dim(h, i)) * fd_model_output_dim(h, i) +
              fd_model_output_dim(h, i);
  }
  std::printf("\nparams  = %" PRId64 "\n", params);
  fd_model_free(h);
  return 0;
}

static int cmd_finfo(const char* path) {
  float* data = nullptr;
  int32_t frames = 0, dim = 0;
  if (fd_read_features(path, &data, &frames, &dim) != 0) {
    std::fprintf(stderr, "error: cannot read feature file %s\n", path);
    return 2;
  }
  double mn = 1e30, mx = -1e30, sum = 0;
  const int64_t count = int64_t(frames) * dim;
  for (int64_t i = 0; i < count; ++i) {
    const double v = data[i];
    if (v < mn) mn = v;
    if (v > mx) mx = v;
    sum += v;
  }
  std::printf("frames = %d\ndim    = %d\nmin    = %.6f\nmax    = %.6f\nmean   = %.6f\n",
              frames, dim, mn, mx, count ? sum / double(count) : 0.0);
  fd_buffer_free(data);
  return 0;
}

static int cmd_text2bin(const char* in, const char* out) {
  void* h = fd_read_features_text(in);
  if (!h) {
    std::fprintf(stderr, "error: cannot parse text feature file %s\n", in);
    return 2;
  }
  // first utterance, like BatchData.loadFromText (BatchData.java:181-183)
  const int32_t frames = fd_ftext_frames(h, 0);
  const int32_t dim = fd_ftext_dim(h, 0);
  const int rc = fd_write_features(out, fd_ftext_data(h, 0), frames, dim);
  if (rc == 0)
    std::printf("wrote %s: %dx%d (utterance '%s' of %d)\n", out, frames, dim,
                fd_ftext_id(h, 0), fd_ftext_count(h));
  else
    std::fprintf(stderr, "error: cannot write %s\n", out);
  fd_ftext_free(h);
  return rc == 0 ? 0 : 2;
}

static int cmd_dump(const char* path, int32_t limit) {
  float* data = nullptr;
  int32_t frames = 0, dim = 0;
  if (fd_read_features(path, &data, &frames, &dim) != 0) {
    std::fprintf(stderr, "error: cannot read feature file %s\n", path);
    return 2;
  }
  if (limit <= 0 || limit > frames) limit = frames;
  for (int32_t r = 0; r < limit; ++r) {
    for (int32_t c = 0; c < dim; ++c)
      std::printf(c ? " %g" : "%g", data[int64_t(r) * dim + c]);
    std::printf("\n");
  }
  fd_buffer_free(data);
  return 0;
}

// -- score-via-server: FDN1 wire protocol client (cli/serve.py) -------------

static bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    const ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= size_t(w);
  }
  return true;
}

static bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    const ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= size_t(r);
  }
  return true;
}

static int cmd_score(const char* addr, const char* feats_path, const char* out_path,
                     const char* fmt) {
  // parse HOST:PORT
  char host[256];
  const char* colon = std::strrchr(addr, ':');
  if (!colon || colon == addr || size_t(colon - addr) >= sizeof(host)) {
    std::fprintf(stderr, "error: server address must be HOST:PORT, got %s\n", addr);
    return 2;
  }
  std::memcpy(host, addr, colon - addr);
  host[colon - addr] = 0;

  float* data = nullptr;
  int32_t frames = 0, dim = 0;
  if (fd_read_features(feats_path, &data, &frames, &dim) != 0) {
    std::fprintf(stderr, "error: cannot read feature file %s\n", feats_path);
    return 2;
  }

  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host, colon + 1, &hints, &res) != 0 || !res) {
    std::fprintf(stderr, "error: cannot resolve %s\n", addr);
    fd_buffer_free(data);
    return 2;
  }
  const int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    std::fprintf(stderr, "error: cannot connect to %s\n", addr);
    freeaddrinfo(res);
    fd_buffer_free(data);
    return 2;
  }
  freeaddrinfo(res);

  // request: "FDN1" | op=1 u8 | n u32le | dim u32le | f32le frames
  // (x86 is little-endian: in-memory floats/ints go to the wire as-is)
  unsigned char head[13];
  std::memcpy(head, "FDN1", 4);
  head[4] = 1;
  const uint32_t n32 = uint32_t(frames), d32 = uint32_t(dim);
  std::memcpy(head + 5, &n32, 4);
  std::memcpy(head + 9, &d32, 4);
  bool ok = send_all(fd, head, sizeof head) &&
            send_all(fd, data, size_t(4) * frames * dim);
  fd_buffer_free(data);

  unsigned char status = 1;
  uint32_t rn = 0, rout = 0;
  std::vector<float> post;
  if (ok) ok = recv_all(fd, &status, 1);
  if (ok && status != 0) {
    uint32_t len = 0;
    std::vector<char> msg;
    if (recv_all(fd, &len, 4) && len < (1u << 20)) {
      msg.resize(len + 1, 0);
      recv_all(fd, msg.data(), len);
    }
    std::fprintf(stderr, "error: server: %s\n", msg.empty() ? "(no message)" : msg.data());
    ::close(fd);
    return 2;
  }
  if (ok) ok = recv_all(fd, &rn, 4) && recv_all(fd, &rout, 4);
  if (ok && (uint64_t(rn) * rout) <= (1u << 30)) {
    post.resize(size_t(rn) * rout);
    ok = recv_all(fd, post.data(), post.size() * 4);
  } else {
    ok = false;
  }
  ::close(fd);
  if (!ok) {
    std::fprintf(stderr, "error: connection failed mid-transfer\n");
    return 2;
  }

  if (!out_path) {
    for (uint32_t r = 0; r < rn; ++r) {
      for (uint32_t c = 0; c < rout; ++c)
        std::printf(c ? " %f" : "%f", post[size_t(r) * rout + c]);
      std::printf("\n");
    }
    return 0;
  }
  if (fmt && !std::strcmp(fmt, "TXT")) {
    std::FILE* out = std::fopen(out_path, "w");
    if (!out) {
      std::fprintf(stderr, "error: cannot write %s\n", out_path);
      return 2;
    }
    for (uint32_t r = 0; r < rn; ++r) {
      for (uint32_t c = 0; c < rout; ++c)
        std::fprintf(out, c ? " %f" : "%f", post[size_t(r) * rout + c]);
      std::fprintf(out, "\n");
    }
    std::fclose(out);
  } else if (fd_write_features(out_path, post.data(), int32_t(rn), int32_t(rout)) != 0) {
    std::fprintf(stderr, "error: cannot write %s\n", out_path);
    return 2;
  }
  std::printf("scored %u x %u -> %s\n", rn, rout, out_path);
  return 0;
}

int main(int argc, char** argv) {
  if (argc >= 4 && !std::strcmp(argv[1], "score"))
    return cmd_score(argv[2], argv[3], argc >= 5 ? argv[4] : nullptr,
                     argc >= 6 ? argv[5] : "BIN");
  if (argc >= 3 && !std::strcmp(argv[1], "info")) return cmd_info(argv[2]);
  if (argc >= 3 && !std::strcmp(argv[1], "finfo")) return cmd_finfo(argv[2]);
  if (argc >= 4 && !std::strcmp(argv[1], "text2bin")) return cmd_text2bin(argv[2], argv[3]);
  if (argc >= 3 && !std::strcmp(argv[1], "dump"))
    return cmd_dump(argv[2], argc >= 4 ? std::atoi(argv[3]) : 0);
  std::fprintf(stderr,
               "usage: fastdnn-io info MODEL.bin | finfo FEATS.bin | "
               "text2bin FEATS.txt OUT.bin | dump FEATS.bin [N] | "
               "score HOST:PORT FEATS.bin [OUT.bin [BIN|TXT]]\n");
  return 1;
}
