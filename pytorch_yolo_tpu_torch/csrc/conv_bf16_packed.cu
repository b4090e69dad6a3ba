// K5's packed route (the RGB stem: conv_bf16.cu's header says what it
// does and why), in a source of its own so that nvcc builds it beside
// conv_bf16.cu's main kernel.  conv_bf16.cu: yolo_conv_bf16 checks the
// arguments and calls the entry below.

#include "conv_bf16.cuh"

namespace {
namespace cb {

// Byte offset of the 16-byte chunk `chunk` of row `row` in a 64-byte-swizzled
// tile: the chunk index XOR address bits 7-8.
__device__ __forceinline__ uint32_t sw64_chunk(int row, int chunk) {
  return (uint32_t)(row * 64 + ((chunk ^ ((row >> 1) & 3)) * 16));
}

template <int BN>
struct PackedLayout {
  static constexpr int kRowBytes = 2 * kPackedK;
  static constexpr int kABytes = kPackedRows * kRowBytes;
  static constexpr int kOffB = kPackedStages * kABytes;                      // BN rows of W
  static constexpr int kOffStaging = kOffB + BN * kRowBytes;                 // 2 x 64 rows
  static constexpr int kOffParams = kOffStaging + 2 * 64 * wg::kStageRow;    // BN fp32 biases
  static constexpr int kOffBars = kOffParams + BN * 4;                       // full, then empty
  static constexpr int kBytes = kOffBars + 2 * kPackedStages * 8 + 1024;     // + alignment slack
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

// K5's packed route.  The RGB stem has K = 27 (3 taps x 3 taps x 3
// channels): the other routes pad C to 8 (K = 72, two 128-byte stages,
// after a padded copy of x) and spend a 64-column tile on 32 outputs.  Here a
// row of A is the 27 values of one output pixel's window and 5 zeros, 64
// bytes, built by the producer warpgroup from 2-byte loads of the 3-channel
// pixels (no padded copy of x), and W is one BN x 32 tile loaded once a
// block (BN = 32, 48 or 64: the smallest that holds O).  A tile is 256
// output pixels: each consumer warpgroup runs two m64nBNk16 pairs on one
// stage, so the per-tile costs (barriers, the epilogue's hand-offs) are paid
// once per 256 pixels, not per 128.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1) conv_bf16_packed_kernel(__grid_constant__ const Params p) {
  using L = PackedLayout<BN>;
  constexpr int kBlocks = kPackedRows / 2 / 64;  // m64 blocks a consumer warpgroup
  constexpr int kChunks = (BN + wg::kChunk - 1) / wg::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full0 = base + L::kOffBars;
  const uint32_t empty0 = full0 + 8 * kPackedStages;
  const ConvBf16Args& a = p.a;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  constexpr int k_real = kPackedTaps * kPackedTaps * kPackedC;
  const int tiles = (a.M + kPackedRows - 1) / kPackedRows;

  // W as BN rows of 32 bf16 of K, zero past O and past K
  const unsigned short* w = reinterpret_cast<const unsigned short*>(a.w);
  for (int i = threadIdx.x; i < BN * 4; i += wg::kThreads) {
    const int o = i / 4, chunk = i % 4;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k0 = chunk * 8 + 2 * e;
      const uint32_t lo = o < a.O && k0 < k_real ? w[o * k_real + k0] : 0u;
      const uint32_t hi = o < a.O && k0 + 1 < k_real ? w[o * k_real + k0 + 1] : 0u;
      v[e] = lo | hi << 16;
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + L::kOffB +
                                                                      sw64_chunk(o, chunk)),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPackedStages; ++s) {
      wg::mbar_init(full0 + 8 * s, 128);  // every producer thread's rows
      wg::mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // W for wgmma
  __syncthreads();

  // No setmaxnreg: every warp keeps 168 registers, which lets a producer
  // thread build its four rows at once (108 loads in flight).
  if (role == 0) {
    // ---------------- producer warpgroup: builds A ----------------
    const unsigned short* x = reinterpret_cast<const unsigned short*>(a.x);
    const int hw = a.Ho * a.Wo;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      wg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t sa = base + stage * L::kABytes;
      uint32_t v[kPackedRows / 128][kPackedK / 2];
#pragma unroll
      for (int j = 0; j < kPackedRows / 128; ++j) {
        const int m = t * kPackedRows + tid + 128 * j;  // neighbouring threads, neighbouring pixels
#pragma unroll
        for (int i = 0; i < kPackedK / 2; ++i) v[j][i] = 0;
        if (m < a.M) {
          const int n = m / hw;
          const int rem = m - n * hw;
          const int oh = rem / a.Wo;
          const int ih0 = oh * a.stride - a.pad;
          const int iw0 = (rem - oh * a.Wo) * a.stride - a.pad;
          const unsigned short* img = x + (long long)n * a.H * a.W * kPackedC;
          // K = (tap row r, tap column q, channel c), as W's (O, 3, 3, 3)
#pragma unroll
          for (int r = 0; r < kPackedTaps; ++r) {
            const int ih = ih0 + r;
#pragma unroll
            for (int q = 0; q < kPackedTaps; ++q) {
              const int iw = iw0 + q;
              const bool ok = (unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W;
              const unsigned short* px = img + ((long long)ih * a.W + iw) * kPackedC;
#pragma unroll
              for (int c = 0; c < kPackedC; ++c) {
                const int k = (r * kPackedTaps + q) * kPackedC + c;
                const uint32_t val = ok ? (uint32_t)__ldg(px + c) : 0u;
                v[j][k / 2] |= val << (16 * (k % 2));
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPackedRows / 128; ++j)
#pragma unroll
        for (int chunk = 0; chunk < 4; ++chunk)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           sa + sw64_chunk(tid + 128 * j, chunk)),
                       "r"(v[j][4 * chunk]), "r"(v[j][4 * chunk + 1]), "r"(v[j][4 * chunk + 2]),
                       "r"(v[j][4 * chunk + 3]));
      // the generic proxy's writes, before the async proxy's wgmma reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg::mbar_arrive(full0 + 8 * stage);
      if (++stage == kPackedStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    const int cw = role - 1;  // rows [kPackedRows / 2 cw, kPackedRows / 2 (cw + 1)) of the tile
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + L::kOffStaging + cw * 64 * wg::kStageRow;
    const uint32_t prm_addr = base + L::kOffParams;
    const bool vec_ok = a.O % 4 == 0;
    if (cw == 0 && tid < BN)
      reinterpret_cast<float*>(smem + L::kOffParams)[tid] = tid < a.O ? a.bias[tid] : 0.0f;
    wg::named_barrier(4, 256);  // both consumer warpgroups see the biases
    const int q = tid % 8;      // the four columns 4q .. 4q + 3 of this thread's stores (BN = 32)
    const uint4 bb = wg::lds128(prm_addr + 16 * q);
    const float4 bias = make_float4(__uint_as_float(bb.x), __uint_as_float(bb.y),
                                    __uint_as_float(bb.z), __uint_as_float(bb.w));
    float acc[kBlocks][BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      wg::mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sa = base + stage * L::kABytes + cw * (kPackedRows / 2) * L::kRowBytes;
      const uint32_t sb = base + L::kOffB;
      wg::wgmma_fence();
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        fence_f(acc[b]);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_bf16<BN>(acc[b], sw64_desc(sa + b * 64 * L::kRowBytes + 32 * kk),
                         sw64_desc(sb + 32 * kk), kk);
      }
      wg::wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) fence_f(acc[b]);
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * stage);
      if (++stage == kPackedStages) {
        stage = 0;
        phase ^= 1;
      }
      // Epilogue, one m64 block and 32-column chunk at a time through the
      // staging rows.
      const long long m0 = (long long)t * kPackedRows + cw * (kPackedRows / 2);
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          if (ch * wg::kChunk >= a.O) break;  // uniform over the warpgroup
          wg::named_barrier(bar_id, 128);  // the last chunk's pieces are written
          if (ch == 0) stage_chunk<0, BN / 2, chunk_width<BN, 0>()>(acc[b], staging, warp, lane);
          if constexpr (kChunks > 1)
            if (ch == 1) stage_chunk<1, BN / 2, chunk_width<BN, 1>()>(acc[b], staging, warp, lane);
          wg::named_barrier(bar_id, 128);
          if constexpr (BN > wg::kChunk) {
            const int live = min(min(wg::kChunk, BN - ch * wg::kChunk), a.O - ch * wg::kChunk);
            store_chunk_fitted(a, vec_ok, staging, prm_addr + 4 * ch * wg::kChunk, tid,
                               LinearRows{m0 + 64 * b, a.M}, ch * wg::kChunk, live);
          } else if (4 * q < a.O) {
            store_rows_for(a, vec_ok, staging + 16 * q, tid / 8, LinearRows{m0 + 64 * b, a.M},
                           4 * q, bias);
          }
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch_packed_bn(const Params& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {
      const cudaError_t err =
          cudaFuncSetAttribute(conv_bf16_packed_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, PackedLayout<BN>::kBytes);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  const int tiles = (p.a.M + kPackedRows - 1) / kPackedRows;
  conv_bf16_packed_kernel<BN>
      <<<tiles < sms ? tiles : sms, wg::kThreads, PackedLayout<BN>::kBytes, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_packed(const Params& p, int bn, int device, int sms, cudaStream_t s) {
  if (bn == 32) return launch_packed_bn<32>(p, device, sms, s);
  if (bn == 48) return launch_packed_bn<48>(p, device, sms, s);
  return launch_packed_bn<64>(p, device, sms, s);
}

}  // namespace cb
}  // namespace

// The packed route's launch for conv_bf16.cu: yolo_conv_bf16, which has
// checked `args` (a cb::ConvBf16Args) and made `device` current.
extern "C" int yolo_conv_bf16_packed(const void* args, int bn, int device, int sms,
                                     void* stream) {
  cb::Params p{};
  p.a = *static_cast<const cb::ConvBf16Args*>(args);
  return (int)cb::launch_packed(p, bn, device, sms, (cudaStream_t)stream);
}
