// K5's halo route (conv_bf16.cu's header says what it does and why), in a
// source of its own so that nvcc builds it beside conv_bf16.cu's main
// kernel.  conv_bf16.cu: yolo_conv_bf16 checks the arguments and calls the
// entry below.

#include "conv_bf16.cuh"

namespace {
namespace cb {

// The halo route (kRouteHalo): a 3x3 conv, pad 1, stride 1, C % 8 == 0 (C %
// 16 == 8 in the plan), at most BN <= 48 outputs, whose input tile, W and
// staging fit in shared memory (ops/kernels.py: conv_bf16_halo).  The im2col boxes bring each
// input pixel into shared memory once a tap, 9 times in all, and bound the
// "im2col16" route by that traffic.  Here a block tile is kHaloTH x
// kHaloTW output pixels, and one tiled TMA box brings the input pixels its
// windows cover (the halo: kHaloTH + 2 rows of kHaloTW + 2 pixels, zeros
// past x's edges, `cp` channels a pixel: C and zeros, the pitch chosen so
// that 8 neighbouring pixels hit 8 different bank groups); the consumers build each k16 step's A fragment from it with
// ldmatrix at per-lane pixel addresses (tap and channel block as an offset)
// and run wgmma with A from registers against W's N-tile, resident in box
// order (as "im2col16": K = (tap, 16-channel block), zero past C).  Two
// halo buffers: the next tile's loads while this one computes.  The
// epilogue is the other routes' (store_chunk_fitted), on the block's pixels.
constexpr int kHaloBufs = 2;

struct HaloParams {
  CUtensorMap tma_x;  // x as (C, W, H, N) bf16, boxes of (cp, hw, hr, 1), zero past the edges
  CUtensorMap tma_w;  // W in box order as (O, K') bytes, boxes of 128 bytes x BN / 2 rows
  ConvBf16Args a;
  int cp;      // channels of a halo pixel (>= 16 nb, zero past C)
  int hw, hr;  // halo pixels a row, rows: kHaloTW + 2, kHaloTH + 2
  int nb;      // 16-channel blocks a tap: ceil(C / 16)
  int ksteps;  // 64-wide chunks of W's K' = 9 * 16 nb
  int tiles_w, tiles_h, tiles;  // tiles = batch * tiles_h * tiles_w (one N-tile: O <= BN)
  int halo_bytes;               // a halo buffer, rounded up to 1024
  int off_halo, off_staging, off_params, off_bars, smem_bytes;
};

// A 4-D tiled TMA box (channels from c, pixels from (w, h) of image n) into
// `dst`, zeros where it falls outside x.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int w, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
}

// The four 8x8 b16 matrices whose rows lanes 0-7, 8-15, 16-23 and 24-31 name.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Keeps A's registers of an in-flight wgmma from being reused before it is done.
__device__ __forceinline__ void fence_a(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Up to kHaloBatch k16 steps of the halo route from step j (tap, 16-channel
// block): their A fragments into `f` by ldmatrix, then their MMAs into
// `part` as one committed batch; on return the batch before (whose
// fragments are `prev`) is done, so `prev` may be written again.
constexpr int kHaloBatch = 4;

template <int BN>
__device__ __forceinline__ void halo_batch(float (&part)[BN / 2], uint32_t (&f)[kHaloBatch][4],
                                           uint32_t (&prev)[kHaloBatch][4], uint32_t halo,
                                           uint32_t w, const HaloParams& p, int j, int count,
                                           bool first, int& tap, int& blk) {
#pragma unroll
  for (int e = 0; e < kHaloBatch; ++e) {
    if (e < count) {
      const int r = tap / 3, q = tap - 3 * (tap / 3);
      ldmatrix_x4(f[e], halo + ((r * p.hw + q) * p.cp + 16 * blk) * 2);
      if (++blk == p.nb) {
        blk = 0;
        ++tap;
      }
    }
  }
  wg::wgmma_fence();  // the fragments are written
#pragma unroll
  for (int e = 0; e < kHaloBatch; ++e)
    if (e < count)
      wgmma_bf16_rs<BN>(part, f[e], wg::sw128_desc(w + ((j + e) >> 2) * BN * 128 + 32 * ((j + e) & 3)),
                        first && e == 0 ? 0 : 1);
  wg::wgmma_commit();
#pragma unroll
  for (int e = 0; e < kHaloBatch; ++e) fence_a(f[e]);
  wgmma_wait<1>();
#pragma unroll
  for (int e = 0; e < kHaloBatch; ++e) fence_a(prev[e]);
}

template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    conv_bf16_halo_kernel(__grid_constant__ const HaloParams p) {
  constexpr int kChunks = (BN + wg::kChunk - 1) / wg::kChunk;
  constexpr int kWChunk = BN * 128;  // bytes of a 64-wide chunk of W's N-tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full0 = base + p.off_bars;
  const uint32_t empty0 = full0 + 8 * kHaloBufs;
  const uint32_t wbar = empty0 + 8 * kHaloBufs;
  const ConvBf16Args& a = p.a;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kHaloBufs; ++b) {
      wg::mbar_init(full0 + 8 * b, 1);   // the TMA thread's expect_tx arrival
      wg::mbar_init(empty0 + 8 * b, 8);  // lane 0 of each consumer warp
    }
    wg::mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 0) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kIssueRegs));
    if (tid != 0) return;
    // W (O <= BN rows), once; K past W's end and rows past O read as zero
    wg::mbar_arrive_expect_tx(wbar, p.ksteps * kWChunk);
    for (int j = 0; j < p.ksteps; ++j)
      for (int h = 0; h < 2; ++h)
        wg::tma_load_2d(base + j * kWChunk + h * (BN / 2) * 128, &p.tma_w, wbar, j * 128,
                        h * (BN / 2));
    const uint32_t bytes = (uint32_t)(p.cp * p.hw * p.hr * 2);
    int buf = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      // (image, tile row, tile column)
      const int tw = t % p.tiles_w, th = t / p.tiles_w % p.tiles_h;
      const int n = t / (p.tiles_w * p.tiles_h);
      wg::mbar_wait(empty0 + 8 * buf, phase ^ 1);
      wg::mbar_arrive_expect_tx(full0 + 8 * buf, bytes);
      tma_load_4d(base + p.off_halo + buf * p.halo_bytes, &p.tma_x, full0 + 8 * buf, 0,
                  tw * kHaloTW - a.pad, th * kHaloTH - a.pad, n);
      if (++buf == kHaloBufs) {
        buf = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kIssueConsumerRegs));
    const int cw = role - 1;  // rows [64 cw, 64 cw + 64) of the block's 128 pixels
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + p.off_staging + cw * 64 * wg::kStageRow;
    float* prm = reinterpret_cast<float*>(smem + p.off_params) + cw * BN;
    const uint32_t prm_addr = wg::smem_u32(prm);
    const bool vec_ok = a.O % 4 == 0;
    for (int c = tid; c < BN; c += 128) prm[c] = c < a.O ? a.bias[c] : 0.0f;
    // this lane's row of the ldmatrix: pixel 16 warp + lane % 8 + 8 (lane / 8 % 2)
    // of the warpgroup's 64, channels 8 (lane / 16) .. + 7 of each 16
    const int prow = 64 * cw + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    const uint32_t lane_off =
        (uint32_t)(((prow / kHaloTW) * p.hw + prow % kHaloTW) * p.cp + 8 * (lane >> 4)) * 2;
    const int steps = 9 * p.nb;  // k16 steps: (tap, 16-channel block), W's box order

    float acc[BN / 2];
    float part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;
    uint32_t fa[kHaloBatch][4], fb[kHaloBatch][4];  // A fragments of the even and odd batches
#pragma unroll
    for (int e = 0; e < kHaloBatch; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[e][i] = fb[e][i] = 0u;

    wg::named_barrier(bar_id, 128);  // the biases are in
    wg::mbar_wait(wbar, 0);          // and W's N-tile
    int buf = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int tw = t % p.tiles_w, th = t / p.tiles_w % p.tiles_h;
      const int n = t / (p.tiles_w * p.tiles_h);
      wg::mbar_wait(full0 + 8 * buf, phase);
      const uint32_t halo = base + p.off_halo + buf * p.halo_bytes + lane_off;
      // Groups of 16 k16 steps (256 of K, the other routes' P = 4 stages)
      // chained into `part`, then added into the tile's sums.
      int tap = 0, blk = 0;  // the next step's tap and 16-channel block
      for (int j0 = 0; j0 < steps; j0 += 16) {
        const int g = min(16, steps - j0);
        wg::wgmma_fence();
        fence_f(part);
#pragma unroll 1
        for (int jj = 0; jj < g; jj += 2 * kHaloBatch) {
          halo_batch<BN>(part, fa, fb, halo, base, p, j0 + jj, min(kHaloBatch, g - jj), jj == 0,
                         tap, blk);
          if (jj + kHaloBatch < g)
            halo_batch<BN>(part, fb, fa, halo, base, p, j0 + jj + kHaloBatch,
                           min(kHaloBatch, g - jj - kHaloBatch), false, tap, blk);
        }
        wgmma_wait<0>();
        fence_f(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = j0 == 0 ? part[i] : __fadd_rn(acc[i], part[i]);
      }
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * buf);  // the halo is read
      if (++buf == kHaloBufs) {
        buf = 0;
        phase ^= 1;
      }

      // Epilogue: 32-column chunks of the block's pixels.
      const BlockRows rows{(long long)n * a.Ho, th * kHaloTH, tw * kHaloTW, 64 * cw, a.Ho, a.Wo};
#pragma unroll 1
      for (int ch = 0; ch < kChunks; ++ch) {
        if (ch * wg::kChunk >= a.O) break;  // uniform over the warpgroup
        wg::named_barrier(bar_id, 128);          // the last chunk's pieces are written
        switch (ch) {
#define CB_STAGE(CH)                                                                   \
  case CH:                                                                             \
    if constexpr (CH < kChunks)                                                        \
      stage_chunk<CH, BN / 2, chunk_width<BN, CH>()>(acc, staging, warp, lane);         \
    break;
          CB_STAGE(0) CB_STAGE(1) CB_STAGE(2) CB_STAGE(3)
#undef CB_STAGE
        }
        wg::named_barrier(bar_id, 128);
        const int live = min(min(wg::kChunk, BN - ch * wg::kChunk), a.O - ch * wg::kChunk);
        store_chunk_fitted(a, vec_ok, staging, prm_addr + 4 * ch * wg::kChunk, tid, rows,
                           ch * wg::kChunk, live);
      }
    }
  }
}

template <int BN>
cudaError_t launch_halo_bn(const HaloParams& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv_bf16_halo_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  // at most one block an SM
  conv_bf16_halo_kernel<BN><<<p.tiles < sms ? p.tiles : sms, wg::kThreads, p.smem_bytes, s>>>(p);
  return cudaGetLastError();
}

// The tiles of the outputs the plan gives this route (at most 48); BN = 128
// would spill (its sums, partial sums and two batches of fragments do not
// fit the 168 registers ptxas allows a thread).
cudaError_t launch_halo(const HaloParams& p, int bn, int device, int sms, cudaStream_t s) {
  if (bn == 32) return launch_halo_bn<32>(p, device, sms, s);
  return launch_halo_bn<48>(p, device, sms, s);
}

// The halo route's geometry and shared memory for a bn-column tile
// (ops/kernels.py: conv_bf16_halo mirrors it); false where it does not fit.
inline bool halo_layout(HaloParams& p, int bn) {
  const ConvBf16Args& a = p.a;
  p.nb = (a.C + 15) / 16;
  // a pitch of an odd number of 16-byte pieces, so that 8 neighbouring
  // pixels' ldmatrix rows fall in 8 bank groups
  p.cp = 16 * p.nb + 8;
  p.hw = kHaloTW + 2;
  p.hr = kHaloTH + 2;
  p.ksteps = (9 * p.nb + kBoxes - 1) / kBoxes;
  p.tiles_w = (a.Wo + kHaloTW - 1) / kHaloTW;
  p.tiles_h = (a.Ho + kHaloTH - 1) / kHaloTH;
  const long long tiles = (long long)a.batch * p.tiles_h * p.tiles_w;
  if (tiles > (1LL << 30)) return false;
  p.tiles = (int)tiles;
  p.halo_bytes = (p.cp * p.hw * p.hr * 2 + 1023) / 1024 * 1024;
  p.off_halo = p.ksteps * bn * 128;
  p.off_staging = p.off_halo + kHaloBufs * p.halo_bytes;
  p.off_params = p.off_staging + 2 * 64 * wg::kStageRow;
  p.off_bars = p.off_params + 2 * bn * 4;
  p.smem_bytes = p.off_bars + 8 * (2 * kHaloBufs + 1) + 1024;
  return p.smem_bytes <= kSmemLimit && p.cp <= 256 && p.hw <= 256;
}

// The halo map of NHWC x: 4-D (C, W, H, N), boxes of (cp, hw, hr, 1), no
// swizzle; channels past C and pixels outside x read as zero.
inline bool encode_halo(CUtensorMap* map, const HaloParams& p) {
  const wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const ConvBf16Args& a = p.a;
  const cuuint64_t dims[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W, (cuuint64_t)a.H,
                              (cuuint64_t)a.batch};
  const cuuint64_t strides[3] = {2ull * a.C, 2ull * a.C * a.W, 2ull * a.C * a.W * a.H};
  const cuuint32_t box[4] = {(cuuint32_t)p.cp, (cuuint32_t)p.hw, (cuuint32_t)p.hr, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<uint8_t*>(a.x), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace cb
}  // namespace

// The halo route's: its geometry, W's and x's maps, the launch; an error
// where shared memory cannot hold it (ops/kernels.py: conv_bf16_halo says
// where it can).
extern "C" int yolo_conv_bf16_halo(const void* args, int bn, int device, int sms,
                                   void* stream) {
  cb::HaloParams h{};
  h.a = *static_cast<const cb::ConvBf16Args*>(args);
  if (!cb::halo_layout(h, bn)) return (int)cudaErrorInvalidValue;
  const long long kb = 9LL * 16 * h.nb;  // W's K' in box order
  if (!cb::encode_rows(&h.tma_w, h.a.w, 2 * kb, h.a.O, 2 * kb, 128, bn / 2) ||
      !cb::encode_halo(&h.tma_x, h))
    return (int)cudaErrorInvalidValue;
  return (int)cb::launch_halo(h, bn, device, sms, (cudaStream_t)stream);
}
