// Native Darknet .weights loader: mmap + fused BN-fold, OIHW out.
//
// A copy of pytorch_yolo_tpu/native/weights_loader.cpp for the PyTorch port,
// whose conv kernels are OIHW (Darknet's stream order and F.conv2d's layout)
// where the JAX package's are HWIO: the fold is the same, the transpose is
// gone.  One pass over an mmap'd file does header validation and BatchNorm
// folding (w' = w * gamma/sqrt(var+eps), b' = beta - mean*gamma/sqrt(var+eps)),
// writing directly into caller-provided (numpy) buffers.  Layers are
// processed by a small thread pool.
//
// C ABI only (consumed via ctypes, no pybind11 in this image).
// Error codes: 0 ok, negative = failure (see pyt_strerror).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr float kBnEps = 1e-5f;

enum ErrorCode : int {
  kOk = 0,
  kOpenFailed = -1,
  kTooSmall = -2,
  kSizeMismatch = -3,
  kMmapFailed = -4,
  kBadArgs = -5,
};

struct LayerDesc {
  int32_t filters;        // output channels
  int32_t in_channels;
  int32_t size;           // kernel spatial size
  int32_t batch_normalize;  // 0/1
  int64_t stream_offset;  // float offset of this layer's params in the body
  float* out_w;           // (filters, in, size, size) OIHW, caller-allocated
  float* out_b;           // (filters,)
};

// Fold one conv layer from the flat stream.
void convert_layer(const float* body, const LayerDesc& d) {
  const int o = d.filters, i = d.in_channels, k = d.size;
  const float* p = body + d.stream_offset;

  std::vector<float> scale(o), bias(o);
  if (d.batch_normalize) {
    const float* bn_beta = p;
    const float* bn_gamma = p + o;
    const float* bn_mean = p + 2 * o;
    const float* bn_var = p + 3 * o;
    for (int c = 0; c < o; ++c) {
      const float s = bn_gamma[c] / std::sqrt(bn_var[c] + kBnEps);
      scale[c] = s;
      bias[c] = bn_beta[c] - bn_mean[c] * s;
    }
    p += 4 * o;
  } else {
    for (int c = 0; c < o; ++c) {
      scale[c] = 1.0f;
      bias[c] = p[c];
    }
    p += o;
  }
  std::memcpy(d.out_b, bias.data(), sizeof(float) * o);

  // stream layout and dest: (o, i, kh, kw) row-major, one sequential pass.
  const int64_t per_out = static_cast<int64_t>(i) * k * k;
  for (int oc = 0; oc < o; ++oc) {
    const float s = scale[oc];
    const float* src = p + oc * per_out;
    float* dst = d.out_w + oc * per_out;
    for (int64_t j = 0; j < per_out; ++j) dst[j] = src[j] * s;
  }
}

}  // namespace

extern "C" {

const char* pyt_strerror(int code) {
  switch (code) {
    case kOk: return "ok";
    case kOpenFailed: return "cannot open file";
    case kTooSmall: return "file shorter than header";
    case kSizeMismatch: return "weight stream size does not match model";
    case kMmapFailed: return "mmap failed";
    case kBadArgs: return "bad arguments";
    default: return "unknown error";
  }
}

// Parse header; returns header size in bytes via *header_bytes and the
// number of body floats via *body_floats. seen (image counter) via *seen.
int pyt_probe(const char* path, int64_t* header_bytes, int64_t* body_floats,
              uint64_t* seen) {
  if (!path || !header_bytes || !body_floats) return kBadArgs;
  struct stat st;
  if (stat(path, &st) != 0) return kOpenFailed;
  if (st.st_size < 12) return kTooSmall;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return kOpenFailed;
  int32_t hdr[3];
  if (read(fd, hdr, 12) != 12) { close(fd); return kTooSmall; }
  int64_t hb = 12;
  uint64_t seen_v = 0;
  if (hdr[0] * 10 + hdr[1] >= 2) {
    if (st.st_size < 20 || read(fd, &seen_v, 8) != 8) { close(fd); return kTooSmall; }
    hb += 8;
  } else {
    int32_t s32 = 0;
    if (st.st_size < 16 || read(fd, &s32, 4) != 4) { close(fd); return kTooSmall; }
    seen_v = static_cast<uint64_t>(s32);
    hb += 4;
  }
  close(fd);
  *header_bytes = hb;
  *body_floats = (st.st_size - hb) / 4;
  if (seen) *seen = seen_v;
  return kOk;
}

// Load + fold all conv layers.  descs[i].stream_offset must be
// the float offset of layer i's parameters within the body stream;
// expected_floats is the total the model requires (validated against file).
int pyt_load_weights(const char* path, const LayerDesc* descs, int n_layers,
                     int64_t expected_floats, int n_threads) {
  if (!path || !descs || n_layers <= 0) return kBadArgs;
  int64_t header_bytes = 0, body_floats = 0;
  int rc = pyt_probe(path, &header_bytes, &body_floats, nullptr);
  if (rc != kOk) return rc;
  if (body_floats != expected_floats) return kSizeMismatch;

  int fd = open(path, O_RDONLY);
  if (fd < 0) return kOpenFailed;
  struct stat st;
  fstat(fd, &st);
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return kMmapFailed;
  const float* body =
      reinterpret_cast<const float*>(static_cast<const char*>(map) + header_bytes);

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    for (;;) {
      const int idx = next.fetch_add(1);
      if (idx >= n_layers) return;
      convert_layer(body, descs[idx]);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  munmap(map, st.st_size);
  return kOk;
}

}  // extern "C"
