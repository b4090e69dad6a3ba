// K5: bf16 implicit-GEMM convolution with the JAX package's epilogue:
// NHWC bf16 activations x (O, KH, KW, C) bf16 weights, fp32 accumulators,
// + fp32 bias, activation in fp32, one rounding to bf16, and optionally a
// Darknet [shortcut] added after that rounding (a bf16 add, one more
// rounding).
//
// Replaces the conv that XLA fused with its epilogue in
// pytorch_yolo_tpu/models/darknet.py: _conv (lines 82-98):
// lax.conv_general_dilated(bf16, bf16, preferred_element_type=fp32), then
// apply_activation(y + b) in fp32, then astype(bf16).  It has no Pallas
// source.  cuDNN's bf16 conv rounds its accumulator to bf16 before a bias
// can be added, so no pass after it can give JAX's numbers: the bias has to
// meet the accumulator in registers.  Every fp conv of a bf16 detector runs
// here, the bf16 glue convs of the int8 path included.
//
// Problem: out[m, o] = sum_k A[m, k] * W[o, k] over the flat k = (tap,
// channel), K = KH*KW*C, with A the implicit im2col of x (Darknet's zero
// padding) and W the weights, K contiguous per output channel.
//
// What bounds it on an H100: yolov3's 3x3 convs do 2*9*C flops per output
// and per input channel, ~600-2300 flops per byte moved at batch 128, above
// the ~295 flops/byte where bf16 tensor cores (989 TFLOP/s) overtake HBM
// (3.35 TB/s); its 1x1 convs at 52x52 (2*C flops per output) and the stem
// (C = 3, 32 outputs, 416x416) are bound by HBM.  The design, on the
// helpers of the int8 core (int8_wgmma.cuh):
//   * one producer warpgroup, two consumer warpgroups, persistent blocks, a
//     ring of stages with a full and an empty mbarrier each; a 128 x BN
//     block tile (BN = 64 up to 64 outputs, else 128), each consumer
//     warpgroup 64 x BN with wgmma.m64nBNk16.f32.bf16.bf16 from swizzled
//     K-major tiles;
//   * A's route, chosen from the shapes alone (ops/kernels.py:
//     conv_bf16_plan), and what bounds it:
//       - "im2col" (every 3x3 conv with C % 64 == 0) and "im2col32" (C % 64
//         == 32): one TMA im2col box a stage, 128 output pixels x 64
//         channels of one tap (128-byte rows, 128-byte swizzle; im2col32:
//         one tap's 32 channels, 64-byte rows), the tap as the box's
//         offsets, the conv's stride as the traversal stride, the padding as
//         the box's corners.  The wrapper passes the corners and a table of
//         each stage's (first channel, tap) (ops/kernels.py:
//         conv_bf16_im2col, conv_bf16_stages); the producer works out only
//         its tile's first pixel.  A tile that crosses an image walks on
//         into the next; one past M reads zeros.  One thread issues every
//         load.  A stage takes an SM 0.50-0.90 us against 0.28 of MMA
//         time at BN = 128 (PERF.md section 6);
//       - "tma" (1x1 stride 1): A as the (M, C) matrix it is; bound by HBM;
//       - "packed" (the RGB stem, 3x3 x 3 channels): 27 values and 5 zeros
//         a 64-byte row, built by the producer from the 3-channel pixels,
//         W one 32 x 32 tile loaded once a block, 256 pixels a tile and
//         BN = 32 (conv_bf16_packed_kernel); bound by HBM and the
//         producer's 2-byte loads;
//       - "gather" (C % 32 != 0: the s2d stem's packed conv; or more
//         stages than the table holds): 16-byte
//         cp.async copies by the producer warpgroup, K walked flat;
//   * two-level accumulation: the tensor cores chain P = kPromote = 4
//     stages (256 of K) into a fresh partial set, then the consumer adds it
//     into the tile's fp32 sums with __fadd_rn, once a group: the MMAs drain
//     once a group, not after each stage.  Each stage is committed on its
//     own and released as soon as its MMAs are done (wgmma.wait_group 1),
//     which keeps the ring full; holding a group's stages to its end was
//     ~15 % slower (PERF.md).  The tensor cores' own accumulation is not an IEEE sum
//     (one chain over K = 4608 gave 99.70 % outputs equal to the exact sum
//     rounded once); chaining 4 stages keeps >= 99.975 % at every
//     tools/k5_accuracy.py shape (P = 1: 99.984 %, 2: 99.985 %; cuDNN's fp32
//     conv 99.945-99.977 %).  Registers: ptxas holds a thread of the
//     384-thread block to 168 (setmaxnreg moves them at run time but does
//     not raise what ptxas allocates), so a consumer keeps the tile's BN / 2
//     sums and one partial set of BN / 2: 128 at BN = 128.  A 256-column
//     tile needs 192 (one n128 set, or two alternating n64 sets so that one's
//     promotion overlaps the other's MMAs): it spilled and ran slower than
//     two 128-column tiles, and at BN = 128 one n128 set ran faster than two
//     alternating n64 sets (exploratory runs on the card).  The two consumer
//     warpgroups overlap each other's promotion;
//   * a cluster of 2 CTAs on neighbouring M-tiles of one N-tile: each CTA
//     loads half of the B stage by TMA multicast for both, so B's L2 reads
//     halve; the empty barriers count both CTAs' consumers (remote arrives
//     without a cluster-scope release: with one the kernel ran far slower).
//     Along M because N-tiles exist only from 256 outputs on; A stays per
//     CTA.  Without the cluster the bf16 step ran 6 % slower (PERF.md);
//   * the epilogue stages 32-column chunks of fp32 sums in shared memory;
//     each thread then turns four columns of one row into bf16 outputs,
//     __fadd_rn(sum, bias), the activation of int8_igemm.cuh (the JAX
//     formulas), __float2bfloat16_rn, and writes them with one 8-byte store.
//     The store loop is compiled once per (activation, shortcut).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py
// phase 13, device time at batch 128): 3x3 s1 52^2 128->256 0.47 ms (cuDNN
// bf16 conv + bias + leaky 0.65), 26^2 256->512 0.40 (cuDNN 0.47), 13^2
// 512->1024 0.37 (cuDNN 0.39), the stem 1.23 (3.7 before this design),
// the 1x1 52^2 256->128 0.12; the bf16 batch-128 step 45.8 -> 32.9 ms.
// The result equals the plain version (ops/kernels.py: conv_bf16_ref, an
// fp32 conv of the same bf16 operands) up to the order of the fp32 sums:
// a bf16 output differs only where those sums straddle a rounding boundary.

#include <cuda_bf16.h>

#include "device_guard.cuh"
#include "int8_igemm.cuh"
#include "int8_wgmma.cuh"

namespace {
namespace cb {

constexpr int kStageK = wg::kBK / 2;  // bf16 of K a stage: one 128-byte swizzle row
// P: the stages of K the tensor cores chain into one partial set (the
// tile's BN columns) before the consumer adds it into the tile's sums.
constexpr int kPromote = 4;

// CTAs of a cluster: neighbouring M-tiles of one N-tile, each loading half
// of the B stage for both (TMA multicast).
constexpr int kCluster = 2;

// How A reaches shared memory (ops/kernels.py: conv_bf16_plan, which also
// picks the stage width: kRouteIm2col32, for C % 64 == 32, takes one tap's
// 32 channels a stage, rows of 64 bytes with 64-byte swizzle).
enum Route {
  kRouteGather = 0,
  kRouteTma = 1,
  kRouteIm2col = 2,
  kRoutePacked = 3,
  kRouteIm2col32 = 4
};

// Entries of the im2col routes' stage table (ops/kernels.py:
// CONV_BF16_MAX_STAGES): the plan sends a conv with more stages to the gather.
constexpr int kMaxStages = 512;

// Bytes of a stage's row of A and of B: 64 bf16 of K, or 32 on kRouteIm2col32.
__host__ __device__ constexpr int row_bytes(int route) {
  return route == kRouteIm2col32 ? 64 : 128;
}

// Shared memory of the main kernel: a ring of stages of A (128 rows) and
// B (BN rows), then the epilogue's staging rows, the biases, the gather's
// row table and the barriers.
template <int BN, int kRow>
struct Layout {
  static constexpr int kStages = 6 * 128 / kRow;  // 6 of 128-byte rows, 12 of 64-byte rows
  static constexpr int kABytes = wg::kBM * kRow;
  static constexpr int kBBytes = BN * kRow;
  static constexpr int kOffB = kStages * kABytes;
  static constexpr int kOffStaging = kOffB + kStages * kBBytes;        // 2 x 64 rows
  static constexpr int kOffParams = kOffStaging + 2 * 64 * wg::kStageRow;  // 2 x BN fp32
  static constexpr int kOffRows = kOffParams + 2 * BN * 4;             // 128 RowInfo
  static constexpr int kOffBars = kOffRows + wg::kBM * 16;             // full, then empty
  static constexpr int kBytes = kOffBars + 2 * kStages * 8 + 1024;     // + alignment slack
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

// The packed route (a 3x3 conv of 3 channels with O <= 32: the RGB stem):
// one stage of K = 32 a tile (27 values and 5 zeros), 64-byte rows, 256
// output pixels a tile.
constexpr int kPackedTaps = 3;
constexpr int kPackedC = 3;
constexpr int kPackedK = 32;
constexpr int kPackedRows = 256;
constexpr int kPackedStages = 4;

// Registers a thread after setmaxnreg where one producer thread issues
// every load (TMA and im2col routes); the gather keeps wg's split, which
// its 128 producer threads need.  As in int8_wgmma.cuh, the consumers'
// increase must not exceed what the producer frees, or the kernel hangs.
constexpr int kIssueRegs = 40;
constexpr int kIssueConsumerRegs = 232;
static_assert(128 * (168 - kIssueRegs) >= 256 * (kIssueConsumerRegs - 168),
              "the consumers would wait forever for registers");

// Mirrors ops/kernels.py: _ConvBf16Args (ctypes).  Pointers first, then ints.
struct ConvBf16Args {
  const uint8_t* x;         // NHWC bf16 (batch, H, W, C), C % 8 == 0 (C = 3: packed route)
  const uint8_t* w;         // (O, KH, KW, C) bf16
  const float* bias;        // (O,) fp32
  const uint8_t* shortcut;  // (M, O) bf16 added after the rounding, or null
  uint8_t* out;             // (M, O) bf16
  int batch, H, W, C, Ho, Wo, O, KH, KW, stride, pad, M, act;
  // im2col routes: the pixel box's lower and upper corners (W, H), from
  // ops/kernels.py: conv_bf16_im2col; a tile's first pixel is
  // (n, lo_h + oh * stride, lo_w + ow * stride).
  int lo_w, lo_h, hi_w, hi_h;
  // im2col routes: the stages of K in order (ops/kernels.py:
  // conv_bf16_stages), each its first channel | W offset << 16 | H offset << 24.
  int stages;
  uint32_t stage_tab[kMaxStages];
};

// Kernel parameters, passed by value as one __grid_constant__ (TMA needs
// the maps in parameter or global memory).
struct Params {
  CUtensorMap tma_b;  // W as (O, K) bf16, addressed in bytes
  CUtensorMap tma_a;  // TMA route: x as (M, C) bf16; im2col route: x as NHWC im2col
  ConvBf16Args a;
  int tiles_n, pairs, ksteps;  // pairs: the clusters' tiles, ceil(M-tiles / 2) * tiles_n
};

// One box of the im2col map (row / 2 channels x 128 pixels): channels from c, pixels
// from (w, h, n) on along the traversal, each read at (w + off_w, h + off_h),
// zero where that falls outside x.
__device__ __forceinline__ void tma_im2col_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int c, int w, int h, int n, uint16_t off_w,
                                              uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(off_w), "h"(off_h)
      : "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 64-byte swizzle:
// rows of 64 bytes, 8-row groups 512 bytes apart (SBO).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// The descriptor of a K-major tile with rows of kRow bytes, swizzled to match.
template <int kRow>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  return kRow == 128 ? wg::sw128_desc(addr) : sw64_desc(addr);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every live thread of the cluster: barrier initialisation before any CTA
// may signal another's barriers, and no CTA exits while another may still.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrives on the mbarrier at `bar` (a shared address of this CTA) in CTA
// `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar), "r"(cta)
      : "memory");
}

// A 2-D TMA box written to `dst` in every CTA of `mask`, each CTA's
// barrier at `bar` credited with its bytes.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c_inner, int c_outer,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer), "h"(mask)
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_f(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CB_F8(i)                                                                      \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CB_F32(i) CB_F8(i), CB_F8(i + 8), CB_F8(i + 16), CB_F8(i + 24)

// d (+)= A(64 x 16, smem) * B(N x 16, smem)^T, both K-major; scale_d = 0
// starts from zero.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : CB_F32(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : CB_F32(0), CB_F32(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : CB_F8(0), CB_F8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef CB_F32
#undef CB_F8

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)bits));
}

// Writes the 32 columns [32 CH, 32 CH + 32) of a consumer warpgroup's
// accumulators to its staging rows.  acc[4j + 2h + e] holds row
// 16 warp + lane/4 + 8h, column 8j + 2(lane%4) + e.
template <int CH, int N>
__device__ __forceinline__ void stage_chunk(const float (&acc)[N], uint32_t staging, int warp,
                                            int lane) {
#pragma unroll
  for (int jj = 0; jj < wg::kChunk / 8; ++jj) {
    const int j = CH * (wg::kChunk / 8) + jj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      wg::sts64(staging + row * wg::kStageRow + (8 * jj + 2 * (lane % 4)) * 4,
                __float_as_uint(acc[4 * j + 2 * h]), __float_as_uint(acc[4 * j + 2 * h + 1]));
    }
  }
}

// Turns four staged columns (o0 .. o0 + 3) of the rows row0, row0 + 16, ...
// into bf16 outputs and stores each row's four with one 8-byte store where
// the row is whole and aligned, else one by one.
template <int kAct, bool kShortcut>
__device__ __forceinline__ void store_rows(const ConvBf16Args& a, bool vec_ok, uint32_t staging,
                                           int row0, long long m0, int o0, float4 bias) {
  const bool whole = vec_ok && o0 + 4 <= a.O;
#pragma unroll 1
  for (int row = row0; row < 64; row += 16) {
    const long long m = m0 + row;
    if (m >= a.M) break;
    const uint4 raw = wg::lds128(staging + row * wg::kStageRow);
    uint32_t y[4] = {bf16_bits(activate(__fadd_rn(__uint_as_float(raw.x), bias.x), kAct)),
                     bf16_bits(activate(__fadd_rn(__uint_as_float(raw.y), bias.y), kAct)),
                     bf16_bits(activate(__fadd_rn(__uint_as_float(raw.z), bias.z), kAct)),
                     bf16_bits(activate(__fadd_rn(__uint_as_float(raw.w), bias.w), kAct))};
    const long long off = (m * a.O + o0) * 2;  // bytes
    if (whole) {
      if constexpr (kShortcut) {
        const uint2 s = *reinterpret_cast<const uint2*>(a.shortcut + off);
        const uint32_t sv[4] = {s.x & 0xFFFFu, s.x >> 16, s.y & 0xFFFFu, s.y >> 16};
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = bf16_bits(__fadd_rn(bf16_value(y[i]), bf16_value(sv[i])));
      }
      asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(a.out + off),
                   "r"(y[0] | y[1] << 16), "r"(y[2] | y[3] << 16));
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(a.shortcut + off);
      unsigned short* dst = reinterpret_cast<unsigned short*>(a.out + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (o0 + i >= a.O) break;
        uint32_t v = y[i];
        if constexpr (kShortcut) v = bf16_bits(__fadd_rn(bf16_value(v), bf16_value(s[i])));
        dst[i] = (unsigned short)v;
      }
    }
  }
}

// store_rows for the call's activation and shortcut: one dispatch a chunk.
__device__ __forceinline__ void store_rows_for(const ConvBf16Args& a, bool vec_ok,
                                               uint32_t staging, int row0, long long m0, int o0,
                                               float4 bias) {
#define CB_ACTS(SC)                                                                  \
  switch (a.act) {                                                                   \
    case kLeaky:                                                                     \
      return store_rows<kLeaky, SC>(a, vec_ok, staging, row0, m0, o0, bias);        \
    case kMish:                                                                      \
      return store_rows<kMish, SC>(a, vec_ok, staging, row0, m0, o0, bias);         \
    case kRelu:                                                                      \
      return store_rows<kRelu, SC>(a, vec_ok, staging, row0, m0, o0, bias);         \
    case kLogistic:                                                                  \
      return store_rows<kLogistic, SC>(a, vec_ok, staging, row0, m0, o0, bias);     \
    default:                                                                         \
      return store_rows<kLinear, SC>(a, vec_ok, staging, row0, m0, o0, bias);       \
  }
  if (a.shortcut != nullptr) {
    CB_ACTS(true)
  } else {
    CB_ACTS(false)
  }
#undef CB_ACTS
}

// A consumer warp's release of a stage it has read: lane 0 arrives on the
// stage's empty barrier in every CTA of the cluster, whose B loads write it.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if (lane != 0) return;
  for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(bar, c);
}

template <int kRoute, int BN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(wg::kThreads, 1)
    conv_bf16_kernel(__grid_constant__ const Params p) {
  constexpr int kRow = row_bytes(kRoute);
  using L = Layout<BN, kRow>;
  constexpr int kStages = L::kStages;
  constexpr bool kGather = kRoute == kRouteGather;
  constexpr bool kIm2col = kRoute == kRouteIm2col || kRoute == kRouteIm2col32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full0 = base + L::kOffBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  const ConvBf16Args& a = p.a;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: the TMA thread's expect_tx arrival (+ 128 cp.async arrivals for
      // the gather); empty: lane 0 of each of the 8 consumer warps of both
      // CTAs, since either CTA's B load writes both CTAs' stage.
      wg::mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      wg::mbar_init(empty0 + 8 * s, 8 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (role == 0) {
    // ---------------- producer warpgroup ----------------
    if constexpr (kGather) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::kProducerRegs));
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kIssueRegs));
      if (tid != 0) return;  // one thread issues every TMA load
    }
    wg::RowInfo* rows = reinterpret_cast<wg::RowInfo*>(smem + L::kOffRows);
    const int chunk = tid & 7;  // 16-byte chunk (8 channels) of a 128-byte row
    const uint32_t swz = (uint32_t)((chunk ^ ((tid >> 3) & 7)) * 16);
    const int taps = a.KH * a.KW;
    const int hw = a.Ho * a.Wo;
    int stage = 0;
    uint32_t phase = 0;
    for (int pair = cluster; pair < p.pairs; pair += clusters) {
      // this CTA's M-tile of the cluster's pair; an M-tile past M (an odd
      // count) reads zeros and stores nothing
      const int m0 = (kCluster * (pair / p.tiles_n) + (int)rank) * wg::kBM;
      const int n0 = (pair % p.tiles_n) * BN;
      // im2col: the tile's first pixel; the box walks on from it, into the
      // next image where the tile crosses one, and past the last image
      // (zeros) where it ends past M.
      int img = 0, h0 = 0, w0 = 0;
      if constexpr (kIm2col) {
        img = m0 / hw;
        const int rem = m0 - img * hw;
        const int oh = rem / a.Wo;
        h0 = a.lo_h + oh * a.stride;
        w0 = a.lo_w + (rem - oh * a.Wo) * a.stride;
      }
      if constexpr (kGather) {
        wg::named_barrier(3, 128);  // every producer thread is done with the last tile's rows
        const int m = m0 + tid;
        wg::RowInfo e;
        if (m < a.M) {
          const int n = m / hw;
          const int rem = m - n * hw;
          const int oh = rem / a.Wo;
          e.base = (long long)n * a.H * a.W * a.C;
          e.ih0 = oh * a.stride - a.pad;
          e.iw0 = (rem - oh * a.Wo) * a.stride - a.pad;
        } else {
          e.base = 0;
          e.ih0 = -(1 << 30);
          e.iw0 = 0;
        }
        rows[tid] = e;
        wg::named_barrier(3, 128);
      }
      for (int s = 0; s < p.ksteps; ++s) {
        wg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t sa = base + stage * L::kABytes;
        const uint32_t sb = base + L::kOffB + stage * L::kBBytes;
        if (tid == 0) {
          wg::mbar_arrive_expect_tx(full, kGather ? L::kBBytes : L::kABytes + L::kBBytes);
          // This CTA's half of the B stage, for both CTAs; K past its end
          // reads as zero (TMA's out-of-bounds fill).
          tma_load_2d_multicast(sb + rank * (BN / kCluster) * kRow, &p.tma_b, full, s * kRow,
                                n0 + (int)rank * (BN / kCluster),
                                (uint16_t)((1 << kCluster) - 1));
          if constexpr (kRoute == kRouteTma) wg::tma_load_2d(sa, &p.tma_a, full, s * wg::kBK, m0);
          if constexpr (kIm2col) {
            const uint32_t e = a.stage_tab[s];  // kRow / 2 channels of one tap
            tma_im2col_4d(sa, &p.tma_a, full, (int)(e & 0xFFFF), w0, h0, img,
                          (uint16_t)((e >> 16) & 0xFF), (uint16_t)(e >> 24));
          }
        }
        if constexpr (kGather) {
          const int k = s * kStageK + chunk * 8;  // flat K of this thread's 8 channels
          const int tap = k / a.C;
          const int c = k - tap * a.C;
          const bool k_in = tap < taps;
          const int r = tap / a.KW;
          const int q = tap - r * a.KW;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int row = (tid >> 3) + 16 * j;
            const wg::RowInfo e = rows[row];
            const int ih = e.ih0 + r;
            const int iw = e.iw0 + q;
            const bool ok = k_in && (unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W;
            const uint8_t* src =
                ok ? a.x + (e.base + ((long long)ih * a.W + iw) * a.C + c) * 2 : a.x;
            wg::cp_async16_u32(sa + row * wg::kBK + swz, src, ok ? 16 : 0);
          }
          wg::cp_async_arrive_noinc(full);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    if constexpr (kGather) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::kConsumerRegs));
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kIssueConsumerRegs));
    }
    const int cw = role - 1;  // rows [64 cw, 64 cw + 64) of the block tile
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + L::kOffStaging + cw * 64 * wg::kStageRow;
    float* prm = reinterpret_cast<float*>(smem + L::kOffParams) + cw * BN;
    const uint32_t prm_addr = wg::smem_u32(prm);
    const bool vec_ok = a.O % 4 == 0;  // a row of bf16 outputs is 8-byte aligned

    float acc[BN / 2];   // the tile's fp32 sums
    float part[BN / 2];  // a group's sums, from the tensor cores
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    for (int pair = cluster; pair < p.pairs; pair += clusters) {
      const int m0 = (kCluster * (pair / p.tiles_n) + (int)rank) * wg::kBM;
      const int n0 = (pair % p.tiles_n) * BN;
      // Groups of g <= kPromote stages: the tensor cores chain a group's MMAs
      // into `part` from zero, each stage committed on its own so that it is
      // released as soon as its MMAs are done; then the consumer adds `part`
      // into the tile's fp32 sums (the tile's first group takes it as it is).
      for (int s = 0; s < p.ksteps; s += kPromote) {
        const int g = min(kPromote, p.ksteps - s);
        uint32_t done = 0;  // the empty barrier of the stage before, once read
        wg::wgmma_fence();
        fence_f(part);
#pragma unroll
        for (int pp = 0; pp < kPromote; ++pp) {
          if (pp < g) {
            wg::mbar_wait(full0 + 8 * stage, phase);
            // cp.async wrote the gathered A through the generic proxy; wgmma
            // reads through the async proxy.
            if (kGather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            const uint32_t sa = base + stage * L::kABytes + cw * 64 * kRow;
            const uint32_t sb = base + L::kOffB + stage * L::kBBytes;
#pragma unroll
            for (int kk = 0; kk < kRow / 32; ++kk)
              wgmma_bf16<BN>(part, sw_desc<kRow>(sa + 32 * kk), sw_desc<kRow>(sb + 32 * kk),
                             (pp == 0 && kk == 0) ? 0 : 1);
            wg::wgmma_commit();
            if (pp > 0) {
              wgmma_wait<1>();  // the stage before is read: free it
              release(done, lane);
            }
            done = empty0 + 8 * stage;
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        wgmma_wait<0>();
        fence_f(part);
        release(done, lane);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = s == 0 ? part[i] : __fadd_rn(acc[i], part[i]);
      }

      // Epilogue: the tile's biases, then 32-column chunks: stage the fp32
      // sums, then turn them into bf16 outputs four columns a thread.
      wg::named_barrier(bar_id, 128);  // the last tile's pieces are written
      for (int c = tid; c < BN; c += 128) prm[c] = n0 + c < a.O ? a.bias[n0 + c] : 0.0f;
#pragma unroll 1
      for (int ch = 0; ch < BN / wg::kChunk; ++ch) {
        if (n0 + ch * wg::kChunk >= a.O) break;  // uniform over the warpgroup
        if (ch > 0) wg::named_barrier(bar_id, 128);  // the last chunk's pieces are written
        switch (ch) {
#define CB_STAGE(CH)                                                       \
  case CH:                                                                 \
    if constexpr (CH < BN / wg::kChunk) stage_chunk<CH>(acc, staging, warp, lane); \
    break;
          CB_STAGE(0) CB_STAGE(1) CB_STAGE(2) CB_STAGE(3)
          CB_STAGE(4) CB_STAGE(5) CB_STAGE(6) CB_STAGE(7)
#undef CB_STAGE
        }
        wg::named_barrier(bar_id, 128);
        // 8 pieces of 4 columns per staged row; a quarter-warp reads one row.
        const int q = tid % 8;
        const int col = ch * wg::kChunk + 4 * q;
        const int o0 = n0 + col;
        if (o0 < a.O) {
          const uint4 bb = wg::lds128(prm_addr + 4 * col);
          const float4 bias = make_float4(__uint_as_float(bb.x), __uint_as_float(bb.y),
                                          __uint_as_float(bb.z), __uint_as_float(bb.w));
          store_rows_for(a, vec_ok, staging + 16 * q, tid / 8, (long long)m0 + 64 * cw, o0, bias);
        }
      }
    }
  }
  cluster_sync();
}

template <int kRoute, int BN>
cudaError_t launch_one(const Params& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  auto kernel = conv_bf16_kernel<kRoute, BN>;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {  // once per instantiation and device
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<BN, row_bytes(kRoute)>::kBytes);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  // whole clusters, at most one CTA an SM
  const int most = sms / kCluster;
  const int grid = kCluster * (p.pairs < most ? p.pairs : most);
  kernel<<<grid, wg::kThreads, Layout<BN, row_bytes(kRoute)>::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <int kRoute>
cudaError_t launch_bn(const Params& p, int bn, int device, int sms, cudaStream_t s) {
  if (bn == 64) return launch_one<kRoute, 64>(p, device, sms, s);
  return launch_one<kRoute, 128>(p, device, sms, s);
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a 64-byte-swizzled
// tile: the chunk index XOR address bits 7-8.
__device__ __forceinline__ uint32_t sw64_chunk(int row, int chunk) {
  return (uint32_t)(row * 64 + ((chunk ^ ((row >> 1) & 3)) * 16));
}

struct PackedLayout {
  static constexpr int kRowBytes = 2 * kPackedK;
  static constexpr int kABytes = kPackedRows * kRowBytes;
  static constexpr int kOffB = kPackedStages * kABytes;                      // 32 rows of W
  static constexpr int kOffStaging = kOffB + 32 * kRowBytes;                 // 2 x 64 rows
  static constexpr int kOffParams = kOffStaging + 2 * 64 * wg::kStageRow;    // 32 fp32 biases
  static constexpr int kOffBars = kOffParams + 32 * 4;                       // full, then empty
  static constexpr int kBytes = kOffBars + 2 * kPackedStages * 8 + 1024;     // + alignment slack
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

// K5's packed route.  The RGB stem has K = 27 (3 taps x 3 taps x 3
// channels): the other routes pad C to 8 (K = 72, two 128-byte stages) and
// spend a 64-column tile on 32 outputs.  Here a row of A is the 27 values
// of one output pixel's window and 5 zeros, 64 bytes, built by the
// producer warpgroup from 2-byte loads of the 3-channel pixels (no padded
// copy of x), and W is one 32 x 32 tile loaded once a block.  A tile is 256
// output pixels: each consumer warpgroup runs two m64n32k16 pairs on one
// stage, so the per-tile costs (barriers, the epilogue's hand-offs) are paid
// once per 256 pixels, not per 128.
__global__ void __launch_bounds__(wg::kThreads, 1) conv_bf16_packed_kernel(__grid_constant__ const Params p) {
  using L = PackedLayout;
  constexpr int kBlocks = kPackedRows / 2 / 64;  // m64 blocks a consumer warpgroup
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

  // W as 32 rows of 32 bf16 of K, zero past O and past K
  const unsigned short* w = reinterpret_cast<const unsigned short*>(a.w);
  for (int i = threadIdx.x; i < 32 * 4; i += wg::kThreads) {
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
    if (cw == 0 && tid < 32)
      reinterpret_cast<float*>(smem + L::kOffParams)[tid] = tid < a.O ? a.bias[tid] : 0.0f;
    wg::named_barrier(4, 256);  // both consumer warpgroups see the biases
    const int q = tid % 8;      // the four columns 4q .. 4q + 3 of this thread's stores
    const uint4 bb = wg::lds128(prm_addr + 16 * q);
    const float4 bias = make_float4(__uint_as_float(bb.x), __uint_as_float(bb.y),
                                    __uint_as_float(bb.z), __uint_as_float(bb.w));
    float acc[kBlocks][16];
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
          wgmma_bf16<32>(acc[b], sw64_desc(sa + b * 64 * L::kRowBytes + 32 * kk),
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
      // Epilogue, one m64 block at a time through the staging rows.
      const long long m0 = (long long)t * kPackedRows + cw * (kPackedRows / 2);
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        wg::named_barrier(bar_id, 128);  // the last block's pieces are written
        stage_chunk<0>(acc[b], staging, warp, lane);
        wg::named_barrier(bar_id, 128);
        if (4 * q < a.O) store_rows_for(a, vec_ok, staging + 16 * q, tid / 8, m0 + 64 * b, 4 * q, bias);
      }
    }
  }
}

cudaError_t launch_packed(const Params& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv_bf16_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PackedLayout::kBytes);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  const int tiles = (p.a.M + kPackedRows - 1) / kPackedRows;
  conv_bf16_packed_kernel<<<tiles < sms ? tiles : sms, wg::kThreads, PackedLayout::kBytes, s>>>(p);
  return cudaGetLastError();
}

typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col from the driver, through the runtime (as
// wg::encode_tiled).
inline EncodeIm2colFn encode_im2col_fn() {
  static const EncodeIm2colFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeIm2col", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeIm2colFn>(ptr)
               : nullptr;
  }();
  return fn;
}

inline CUtensorMapSwizzle swizzle_of(int row) {
  return row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// A 2-D bf16 map over (rows, cols bytes) with row stride `pitch` bytes, in
// boxes of `row` bytes x box_rows rows, swizzled to match; out-of-bounds
// elements read as zero.
inline bool encode_rows(CUtensorMap* map, const void* ptr, long long cols, long long rows,
                        long long pitch, int row, int box_rows) {
  const wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)row, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The im2col map of NHWC x: boxes of row / 2 channels x 128 output pixels,
// swizzled as a 2-D box of (128 rows, `row` bytes), the pixels walked at the
// conv's stride over the box between the corners; out-of-bounds pixels read
// as zero.
inline bool encode_im2col(CUtensorMap* map, const ConvBf16Args& a, int row) {
  const EncodeIm2colFn fn = encode_im2col_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W, (cuuint64_t)a.H,
                              (cuuint64_t)a.batch};
  const cuuint64_t strides[3] = {2ull * a.C, 2ull * a.C * a.W, 2ull * a.C * a.W * a.H};
  const int lo[2] = {a.lo_w, a.lo_h};
  const int hi[2] = {a.hi_w, a.hi_h};
  const cuuint32_t elem[4] = {1, (cuuint32_t)a.stride, (cuuint32_t)a.stride, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<uint8_t*>(a.x), dims, strides,
            lo, hi, row / 2, wg::kBM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace cb
}  // namespace

// Launches K5 on `stream` with a `bn`-column tile (64 or 128) and A by
// `route` (cb::Route: 0 the 16-byte gather, 1 TMA for a 1x1 stride-1
// unpadded conv, 2 TMA im2col for C % 64 == 0, 3 the packed RGB stem, 4 TMA
// im2col a tap's 32 channels a stage); returns a CUDA error code (0 = ok).  `args` points to a ConvBf16Args (ops/kernels.py:
// _ConvBf16Args).  Requires C % 8 == 0 and x, w, shortcut and out 16-byte
// aligned (ops/kernels.py: conv_bf16 checks and pads).
extern "C" int yolo_conv_bf16(const void* args, int bn, int route, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaSuccess;
  const cb::ConvBf16Args& a = *static_cast<const cb::ConvBf16Args*>(args);
  const bool packed = route == cb::kRoutePacked;
  const bool im2col = route == cb::kRouteIm2col || route == cb::kRouteIm2col32;
  const int row = cb::row_bytes(route);
  if ((!packed && a.C % 8 != 0) || (!packed && bn != 64 && bn != 128) || route < 0 ||
      route > 4 ||
      (packed && (a.KH != cb::kPackedTaps || a.KW != cb::kPackedTaps || a.C != cb::kPackedC ||
                  a.O > 32)) ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      reinterpret_cast<uintptr_t>(a.out) % 16 || reinterpret_cast<uintptr_t>(a.shortcut) % 16 ||
      (route == cb::kRouteTma && (a.KH != 1 || a.KW != 1 || a.stride != 1 || a.pad != 0)) ||
      (im2col && (a.C % (row / 2) != 0 || a.stages > cb::kMaxStages ||
                  (long long)a.stages * (row / 2) != (long long)a.KH * a.KW * a.C)))
    return (int)cudaErrorInvalidValue;
  if (a.M == 0 || a.O == 0) return 0;
  cb::Params p{};
  p.a = a;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (packed) return (int)cb::launch_packed(p, device, sms, s);
  const long long k = (long long)a.KH * a.KW * a.C;
  // B in boxes of half a stage: each CTA of a cluster loads one half for both
  if (!cb::encode_rows(&p.tma_b, a.w, 2 * k, a.O, 2 * k, row, bn / cb::kCluster))
    return (int)cudaErrorInvalidValue;
  if (route == cb::kRouteTma &&
      !cb::encode_rows(&p.tma_a, a.x, 2LL * a.C, a.M, 2LL * a.C, row, wg::kBM))
    return (int)cudaErrorInvalidValue;
  if (im2col && !cb::encode_im2col(&p.tma_a, a, row))
    return (int)cudaErrorInvalidValue;
  p.ksteps = (int)((2 * k + row - 1) / row);
  p.tiles_n = (a.O + bn - 1) / bn;
  const int tiles_m = (a.M + wg::kBM - 1) / wg::kBM;
  p.pairs = (tiles_m + cb::kCluster - 1) / cb::kCluster * p.tiles_n;
  if (route == cb::kRouteTma) return (int)cb::launch_bn<cb::kRouteTma>(p, bn, device, sms, s);
  if (route == cb::kRouteIm2col32)
    return (int)cb::launch_bn<cb::kRouteIm2col32>(p, bn, device, sms, s);
  if (route == cb::kRouteIm2col) return (int)cb::launch_bn<cb::kRouteIm2col>(p, bn, device, sms, s);
  return (int)cb::launch_bn<cb::kRouteGather>(p, bn, device, sms, s);
}
