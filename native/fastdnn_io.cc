// fastdnn_io — native host-side data plane for fastdnn_tpu.
//
// The engine's equivalent of the reference's C++ model/feature loaders
// (BinaryLoader/FloatDnn/BatchData, /root/reference/src/cpp/float_dnn.cc):
// the compute path is JAX/Pallas, but bulk file parsing — big-endian
// byte-swapping of multi-hundred-MB model/feature files — stays native for
// speed.  Exposed as a C ABI consumed from Python via ctypes
// (fastdnn_tpu/formats/native.py); no pybind11 dependency.
//
// Formats (big-endian 4-byte ints/floats, see formats/binary.py):
//   model:    i32 layer_count, per layer {i32 in, i32 out, f32 w[out*in],
//             f32 bias[out]}, f32 shift[in0], f32 scale[in0]
//   features: i32 frames, i32 dim, f32 data[frames*dim]
//
// Build: make -C native   (produces fastdnn_tpu/_native/libfastdnn_io.so)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Whole-file slurp (the reference slurps too, float_dnn.cc:166-191).
char* slurp(const char* path, int64_t* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::rewind(f);
  // +1 NUL terminator: the text parser tokenizes with strtof, which must
  // never scan past the buffer on files that end mid-number
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(size) + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  const size_t got = std::fread(buf, 1, static_cast<size_t>(size), f);
  std::fclose(f);
  if (got != static_cast<size_t>(size)) {
    std::free(buf);
    return nullptr;
  }
  buf[size] = '\0';
  *size_out = size;
  return buf;
}

inline uint32_t bswap(uint32_t v) { return __builtin_bswap32(v); }

// Byte-swap a big-endian u32 stream into native-endian, vectorizable.
void bswap_block(const uint32_t* src, uint32_t* dst, int64_t count) {
  for (int64_t i = 0; i < count; ++i) dst[i] = bswap(src[i]);
}

inline int32_t read_i32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  v = bswap(v);
  int32_t out;
  std::memcpy(&out, &v, 4);
  return out;
}

struct Layer {
  int32_t input_dim;
  int32_t output_dim;
  float* weights;  // [output_dim * input_dim], file order (node-major)
  float* bias;     // [output_dim]
};

struct Model {
  std::vector<Layer> layers;
  float* shift = nullptr;
  float* scale = nullptr;
  ~Model() {
    for (auto& l : layers) {
      std::free(l.weights);
      std::free(l.bias);
    }
    std::free(shift);
    std::free(scale);
  }
};

float* swap_floats(const char*& p, const char* end, int64_t count) {
  if (p + 4 * count > end) return nullptr;
  float* out = static_cast<float*>(std::malloc(4 * count));
  if (!out) return nullptr;
  bswap_block(reinterpret_cast<const uint32_t*>(p),
              reinterpret_cast<uint32_t*>(out), count);
  p += 4 * count;
  return out;
}

}  // namespace

extern "C" {

// ---- model ---------------------------------------------------------------

void* fd_read_model(const char* path) {
  int64_t size = 0;
  char* buf = slurp(path, &size);
  if (!buf) return nullptr;
  const char* p = buf;
  const char* end = buf + size;
  Model* m = new Model();
  bool ok = size >= 4;
  int32_t layer_count = ok ? read_i32(p) : 0;
  p += 4;
  if (layer_count <= 0 || layer_count > 10000) ok = false;
  for (int32_t i = 0; ok && i < layer_count; ++i) {
    if (p + 8 > end) {
      ok = false;
      break;
    }
    Layer l;
    l.input_dim = read_i32(p);
    l.output_dim = read_i32(p + 4);
    p += 8;
    if (l.input_dim <= 0 || l.output_dim <= 0) {
      ok = false;
      break;
    }
    l.weights = swap_floats(p, end, int64_t(l.input_dim) * l.output_dim);
    l.bias = swap_floats(p, end, l.output_dim);
    if (!l.weights || !l.bias) {
      std::free(l.weights);
      std::free(l.bias);
      ok = false;
      break;
    }
    m->layers.push_back(l);
  }
  if (ok) {
    const int64_t in0 = m->layers[0].input_dim;
    m->shift = swap_floats(p, end, in0);
    m->scale = swap_floats(p, end, in0);
    ok = m->shift && m->scale;
  }
  std::free(buf);
  if (!ok) {
    delete m;
    return nullptr;
  }
  return m;
}

int32_t fd_model_layer_count(void* h) {
  return static_cast<int32_t>(static_cast<Model*>(h)->layers.size());
}
int32_t fd_model_input_dim(void* h, int32_t i) {
  return static_cast<Model*>(h)->layers[i].input_dim;
}
int32_t fd_model_output_dim(void* h, int32_t i) {
  return static_cast<Model*>(h)->layers[i].output_dim;
}
const float* fd_model_weights(void* h, int32_t i) {
  return static_cast<Model*>(h)->layers[i].weights;
}
const float* fd_model_bias(void* h, int32_t i) {
  return static_cast<Model*>(h)->layers[i].bias;
}
const float* fd_model_shift(void* h) { return static_cast<Model*>(h)->shift; }
const float* fd_model_scale(void* h) { return static_cast<Model*>(h)->scale; }
void fd_model_free(void* h) { delete static_cast<Model*>(h); }

// ---- features ------------------------------------------------------------

// Reads a feature matrix; caller owns *data (free with fd_buffer_free).
// Returns 0 on success.  Trusts the header frame count like both reference
// readers (float_dnn.cc:88-102, BatchData.java:82-90).
int32_t fd_read_features(const char* path, float** data, int32_t* frames,
                         int32_t* dim) {
  int64_t size = 0;
  char* buf = slurp(path, &size);
  if (!buf || size < 8) {
    std::free(buf);
    return 1;
  }
  const int32_t n = read_i32(buf);
  const int32_t d = read_i32(buf + 4);
  if (n < 0 || d <= 0 || 8 + int64_t(n) * d * 4 > size) {
    std::free(buf);
    return 2;
  }
  float* out = static_cast<float*>(std::malloc(int64_t(n) * d * 4));
  if (!out) {
    std::free(buf);
    return 3;
  }
  bswap_block(reinterpret_cast<const uint32_t*>(buf + 8),
              reinterpret_cast<uint32_t*>(out), int64_t(n) * d);
  std::free(buf);
  *data = out;
  *frames = n;
  *dim = d;
  return 0;
}

int32_t fd_write_features(const char* path, const float* data, int32_t frames,
                          int32_t dim) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  uint32_t hdr[2];
  std::memcpy(hdr, &frames, 4);
  std::memcpy(hdr + 1, &dim, 4);
  hdr[0] = bswap(hdr[0]);
  hdr[1] = bswap(hdr[1]);
  std::fwrite(hdr, 4, 2, f);
  const int64_t count = int64_t(frames) * dim;
  std::vector<uint32_t> swapped(static_cast<size_t>(count));
  bswap_block(reinterpret_cast<const uint32_t*>(data), swapped.data(), count);
  const size_t wrote = std::fwrite(swapped.data(), 4, swapped.size(), f);
  std::fclose(f);
  return wrote == swapped.size() ? 0 : 2;
}


// ---------------------------------------------------------------------------
// Kaldi text feature parsing (BatchData.loadMultipleFromText analog,
// suskun/nn/BatchData.java:145-183): utterances of the form
//     utt-id  [
//       f f f ...
//       f f f ]
// Tokenized with strtof — ~an order of magnitude faster than the Python
// regex path on multi-MB feature files.
// ---------------------------------------------------------------------------

struct Utt {
  std::string id;
  int32_t frames = 0;
  int32_t dim = 0;
  float* data = nullptr;  // malloc'd [frames * dim]
  ~Utt() { std::free(data); }
};

struct FText {
  std::vector<Utt*> utts;
  ~FText() {
    for (Utt* u : utts) delete u;
  }
};

void* fd_read_features_text(const char* path) {
  int64_t size = 0;
  char* buf = slurp(path, &size);
  if (!buf) return nullptr;
  FText* out = new FText();
  const char* p = buf;
  const char* end = buf + size;
  while (p < end) {
    // skip whitespace
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    // utterance id: token up to whitespace
    const char* id0 = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p)) && *p != '[') ++p;
    std::string id(id0, p - id0);
    while (p < end && *p != '[') ++p;  // find opening bracket
    if (p >= end) break;
    ++p;  // past '['
    // parse rows: floats separated by spaces, newline ends a row, ']' ends
    std::vector<float> vals;
    int32_t dim = 0, frames = 0;
    int32_t row_len = 0;
    bool bad = false;
    while (p < end) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p < end && *p == '\n') {
        if (row_len > 0) {
          if (dim == 0) dim = row_len;
          else if (row_len != dim) { bad = true; break; }
          ++frames;
          row_len = 0;
        }
        ++p;
        continue;
      }
      if (p >= end || *p == ']') {
        if (row_len > 0) {
          if (dim == 0) dim = row_len;
          else if (row_len != dim) { bad = true; break; }
          ++frames;
        }
        if (p < end) ++p;  // past ']'
        break;
      }
      char* next = nullptr;
      float v = std::strtof(p, &next);
      if (next == p) { bad = true; break; }
      vals.push_back(v);
      ++row_len;
      p = next;
    }
    if (bad || dim == 0 || frames == 0 ||
        vals.size() != size_t(frames) * size_t(dim)) {
      delete out;
      std::free(buf);
      return nullptr;
    }
    Utt* u = new Utt();
    u->id = std::move(id);
    u->frames = frames;
    u->dim = dim;
    u->data = static_cast<float*>(std::malloc(vals.size() * 4));
    std::memcpy(u->data, vals.data(), vals.size() * 4);
    out->utts.push_back(u);
  }
  std::free(buf);
  if (out->utts.empty()) {
    delete out;
    return nullptr;
  }
  return out;
}

int32_t fd_ftext_count(void* h) {
  return static_cast<int32_t>(static_cast<FText*>(h)->utts.size());
}
const char* fd_ftext_id(void* h, int32_t i) {
  return static_cast<FText*>(h)->utts[i]->id.c_str();
}
int32_t fd_ftext_frames(void* h, int32_t i) {
  return static_cast<FText*>(h)->utts[i]->frames;
}
int32_t fd_ftext_dim(void* h, int32_t i) {
  return static_cast<FText*>(h)->utts[i]->dim;
}
const float* fd_ftext_data(void* h, int32_t i) {
  return static_cast<FText*>(h)->utts[i]->data;
}
void fd_ftext_free(void* h) { delete static_cast<FText*>(h); }

void fd_buffer_free(float* p) { std::free(p); }

}  // extern "C"
