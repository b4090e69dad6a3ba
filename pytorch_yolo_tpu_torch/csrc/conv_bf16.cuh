// K5's shared pieces (csrc/conv_bf16.cu, conv_bf16_packed.cu and
// conv_bf16_halo.cu): the
// routes' constants, the C argument structs, the TMA, wgmma and barrier
// helpers, the epilogue's store loops and the tensor-map encoders.  Each
// source that includes it compiles its own copy (anonymous namespace), so
// the sources build in parallel; they meet only through extern "C" entries
// that take `const void*`.

#pragma once

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
// picks the stage width: kRouteIm2col32, for C = 32, takes one tap's 32
// channels a stage, rows of 64 bytes with 64-byte swizzle; kRouteIm2colPad,
// for the other C % 64 == 32, boxes of 64 channels of one tap in 128-byte
// rows, a tap's last box half past C; kRouteIm2col16, for the other C % 8
// == 0 whose W fits in shared memory, four boxes of 16 channels a stage,
// rows of 32 bytes with 32-byte swizzle).
enum Route {
  kRouteGather = 0,
  kRouteTma = 1,
  kRouteIm2col = 2,
  kRoutePacked = 3,
  kRouteIm2col32 = 4,
  // W's N-tile resident in shared memory beside a ring of at least
  // kMinRing A stages (the plan sends a conv whose W does not fit to the
  // gather)
  kRouteIm2col16 = 5,
  // a 3x3 conv from a halo tile of x in shared memory (conv_bf16_halo_kernel)
  kRouteHalo = 6,
  // kRouteIm2col's stage, 64 channels of one tap, for C % 64 == 32 (C > 32):
  // ceil(C / 64) boxes a tap, the last one's upper 32 channels read as zero
  // (TMA's out-of-bounds fill), W repacked once to 64 ceil(C / 64) channels
  kRouteIm2colPad = 7
};

// kRouteIm2colPad at BN = kPairBN: the cluster's two CTAs take one M-tile
// and neighbouring N-tiles; each loads half of A's rows (kBM / 2 pixels)
// for both by TMA multicast, and its own B.
constexpr int kPairBN = 80;

// Entries of the im2col routes' stage table (ops/kernels.py:
// CONV_BF16_MAX_STAGES), one a box: the plan sends a conv with more boxes to
// the gather.
constexpr int kMaxStages = 512;

// kRouteIm2col16: boxes of 128 pixels x 16 channels (32-byte rows) a stage,
// each its own 32-byte-swizzled sub-tile of A and one k16 wgmma against a
// 32-byte column of the stage's B rows (W repacked in box order).
constexpr int kBoxes = 4;
constexpr int kBoxRow = 32;
constexpr int kBoxBytes = 128 * kBoxRow;
// kRouteIm2col16: A stages of the ring (kBoxes boxes each) beside W.
constexpr int kMinRing = 4;
constexpr int kMaxRing = 8;
constexpr int kSmemLimit = 232448;  // the 227 KB a block may use

// Bytes of a stage's row of A and of B: 64 bf16 of K, or 32 on kRouteIm2col32
// (kRouteIm2col16: B's row; A is kBoxes boxes of kBoxRow-byte rows).
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

// The packed route (a 3x3 conv of 3 channels with O <= 64: the RGB stem):
// one stage of K = 32 a tile (27 values and 5 zeros), 64-byte rows, 256
// output pixels a tile, a BN-column tile of 32, 48 or 64.
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
  // im2col routes: the boxes of K in order (ops/kernels.py:
  // conv_bf16_stages), each its first channel | W offset << 16 | H offset << 24;
  // one a stage, or kBoxes a stage on kRouteIm2col16.
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
  // kRouteIm2col16's shared memory (byte offsets from the aligned base):
  // a ring of `ring` A stages, W's N-tile (ksteps chunks of BN rows x 128
  // bytes), the epilogue's staging rows, the biases, the barriers
  int ring, off_w, off_staging, off_params, off_bars, smem_bytes;
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

// tma_im2col_4d written to `dst` in every CTA of `mask`, each CTA's barrier
// at `bar` credited with its bytes.
__device__ __forceinline__ void tma_im2col_4d_multicast(uint32_t dst, const CUtensorMap* map,
                                                        uint32_t bar, int c, int w, int h, int n,
                                                        uint16_t off_w, uint16_t off_h,
                                                        uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8}, %9;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(off_w), "h"(off_h), "h"(mask)
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

// ... with 32-byte swizzle: rows of 32 bytes (one k16 step), 8-row groups 256
// bytes apart.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
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

// n48 and n80: the tiles fitted to 40 and 80 (and 2 x 80) outputs.
template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[24], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : CB_F8(0), CB_F8(8), CB_F8(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<80>(float (&d)[40], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : CB_F32(0), CB_F8(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A(64 x 16, registers: the mma.m16n8k16 A fragment of each warp's
// 16 rows) * B(N x 16, smem)^T, B K-major; the halo route's product.
template <int BN>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d);


template <>
__device__ __forceinline__ void wgmma_bf16_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : CB_F8(0), CB_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : CB_F8(0), CB_F8(8), CB_F8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : CB_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : CB_F32(0), CB_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef CB_F32
#undef CB_F8

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)bits));
}

// Columns of chunk CH of a BN-column tile: 32, or the 16 at the end of a
// tile of 48 or 80.
template <int BN, int CH>
__host__ __device__ constexpr int chunk_width() {
  return BN - CH * wg::kChunk < wg::kChunk ? BN - CH * wg::kChunk : wg::kChunk;
}

// Writes the columns [32 CH, 32 CH + W) of a consumer warpgroup's
// accumulators to its staging rows.  acc[4j + 2h + e] holds row
// 16 warp + lane/4 + 8h, column 8j + 2(lane%4) + e.
template <int CH, int N, int W = wg::kChunk>
__device__ __forceinline__ void stage_chunk(const float (&acc)[N], uint32_t staging, int warp,
                                            int lane) {
  static_assert(W % 8 == 0 && W <= wg::kChunk && 4 * (CH * wg::kChunk + W) / 8 <= N,
                "a chunk of whole 8-column groups inside the tile");
#pragma unroll
  for (int jj = 0; jj < W / 8; ++jj) {
    const int j = CH * (wg::kChunk / 8) + jj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      wg::sts64(staging + row * wg::kStageRow + (8 * jj + 2 * (lane % 4)) * 4,
                __float_as_uint(acc[4 * j + 2 * h]), __float_as_uint(acc[4 * j + 2 * h + 1]));
    }
  }
}

// Four staged fp32 sums of a row (columns o0 .. o0 + 3) as bf16 outputs:
// + bias, the activation, one rounding.
template <int kAct>
__device__ __forceinline__ void activate4(uint32_t (&y)[4], uint4 raw, float4 bias) {
  y[0] = bf16_bits(activate(__fadd_rn(__uint_as_float(raw.x), bias.x), kAct));
  y[1] = bf16_bits(activate(__fadd_rn(__uint_as_float(raw.y), bias.y), kAct));
  y[2] = bf16_bits(activate(__fadd_rn(__uint_as_float(raw.z), bias.z), kAct));
  y[3] = bf16_bits(activate(__fadd_rn(__uint_as_float(raw.w), bias.w), kAct));
}

// Stores row m's four outputs y (columns o0 .. o0 + 3), the [shortcut]
// added where there is one, with one 8-byte store where the row's four are
// whole and aligned, else one by one.
template <bool kShortcut>
__device__ __forceinline__ void store_row(const ConvBf16Args& a, bool whole, long long m, int o0,
                                          uint32_t (&y)[4]) {
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

// The output pixels of a consumer warpgroup's 64 staged rows: consecutive
// pixels of M from m0 (the tiles of M) ...
struct LinearRows {
  long long m0, M;
  __device__ __forceinline__ bool pixel(int row, long long& m) const {
    m = m0 + row;
    return m < M;
  }
};

// ... or, on the halo route, rows [rbase, rbase + 64) of a kHaloTH x
// kHaloTW block of output pixels from (oh0, ow0) of image n (img = n Ho),
// the ones past the image's edge stored nowhere.
constexpr int kHaloTW = 32;
constexpr int kHaloTH = wg::kBM / kHaloTW;
struct BlockRows {
  long long img;
  int oh0, ow0, rbase, Ho, Wo;
  __device__ __forceinline__ bool pixel(int row, long long& m) const {
    const int r = rbase + row;
    const int oh = oh0 + r / kHaloTW, ow = ow0 + r % kHaloTW;
    m = (img + oh) * Wo + ow;
    return oh < Ho && ow < Wo;
  }
};

// Turns four staged columns (o0 .. o0 + 3) of the rows row0, row0 + 64 /
// kRows, ... of a consumer warpgroup's 64 into bf16 outputs and stores
// them at the pixels `rows` names.  kRows = 0: the four rows row0, row0 +
// 16, ... one after another (the 64- and 128-column tiles of M, whose
// 128-column consumers already hold 128 live sums of the 168 registers a
// thread has); else kRows rows whose activations are computed together (4
// kRows independent ones a thread), then stored.
template <int kAct, bool kShortcut, int kRows, typename Rows>
__device__ __forceinline__ void store_rows(const ConvBf16Args& a, bool vec_ok, uint32_t staging,
                                           int row0, const Rows& rows, int o0, float4 bias) {
  const bool whole = vec_ok && o0 + 4 <= a.O;
  if constexpr (kRows == 0) {
#pragma unroll 1
    for (int row = row0; row < 64; row += 16) {
      long long m;
      if (!rows.pixel(row, m)) break;
      uint32_t y[4];
      activate4<kAct>(y, wg::lds128(staging + row * wg::kStageRow), bias);
      store_row<kShortcut>(a, whole, m, o0, y);
    }
  } else {
    constexpr int kStep = 64 / kRows;
    uint32_t y[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      activate4<kAct>(y[r], wg::lds128(staging + (row0 + kStep * r) * wg::kStageRow), bias);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      long long m;
      if (rows.pixel(row0 + kStep * r, m)) store_row<kShortcut>(a, whole, m, o0, y[r]);
    }
  }
}

// store_rows for the call's activation and shortcut: one dispatch a chunk.
template <int kRows = 0, typename Rows = LinearRows>
__device__ __forceinline__ void store_rows_for(const ConvBf16Args& a, bool vec_ok,
                                               uint32_t staging, int row0, const Rows& rows,
                                               int o0, float4 bias) {
#define CB_ACTS(SC)                                                                        \
  switch (a.act) {                                                                         \
    case kLeaky:                                                                           \
      return store_rows<kLeaky, SC, kRows>(a, vec_ok, staging, row0, rows, o0, bias);     \
    case kMish:                                                                            \
      return store_rows<kMish, SC, kRows>(a, vec_ok, staging, row0, rows, o0, bias);      \
    case kRelu:                                                                            \
      return store_rows<kRelu, SC, kRows>(a, vec_ok, staging, row0, rows, o0, bias);      \
    case kLogistic:                                                                        \
      return store_rows<kLogistic, SC, kRows>(a, vec_ok, staging, row0, rows, o0, bias);  \
    default:                                                                               \
      return store_rows<kLinear, SC, kRows>(a, vec_ok, staging, row0, rows, o0, bias);    \
  }
  if (a.shortcut != nullptr) {
    CB_ACTS(true)
  } else {
    CB_ACTS(false)
  }
#undef CB_ACTS
}

// The stores of a staged chunk of the tiles fitted to O (48 and 80 columns,
// the packed route's 48 and 64, the halo route's), whose last chunk may
// hold 16 or 8 live columns: 8 threads a row (4 rows a thread) where more
// than 16 columns are live, 4 (2 rows) where more than 8, else 2 (one row),
// so that a narrow chunk keeps its lanes busy; each thread four columns.
// `live`: the chunk's columns in O; `prm`: the chunk's biases; `o0`: its
// first output column; `rows`: the staged rows' pixels.
template <typename Rows>
__device__ __forceinline__ void store_chunk_fitted(const ConvBf16Args& a, bool vec_ok,
                                                   uint32_t staging, uint32_t prm, int tid,
                                                   const Rows& rows, int o0, int live) {
  const int per_row = live > 16 ? 8 : live > 8 ? 4 : 2;
  const int q = tid % per_row;
  if (4 * q >= live) return;
  const uint4 bb = wg::lds128(prm + 16 * q);
  const float4 bias = make_float4(__uint_as_float(bb.x), __uint_as_float(bb.y),
                                  __uint_as_float(bb.z), __uint_as_float(bb.w));
  const uint32_t st = staging + 16 * q;
  const int row0 = tid / per_row;
  if (per_row == 8) return store_rows_for<4>(a, vec_ok, st, row0, rows, o0 + 4 * q, bias);
  if (per_row == 4) return store_rows_for<2>(a, vec_ok, st, row0, rows, o0 + 4 * q, bias);
  store_rows_for<1>(a, vec_ok, st, row0, rows, o0 + 4 * q, bias);
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
  return row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
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

// The im2col map of NHWC x: boxes of row / 2 channels x `pixels` output
// pixels, swizzled as a 2-D box of (`pixels` rows, `row` bytes), the pixels
// walked at the conv's stride over the box between the corners;
// out-of-bounds pixels and channels read as zero.
inline bool encode_im2col(CUtensorMap* map, const ConvBf16Args& a, int row,
                          int pixels = wg::kBM) {
  const EncodeIm2colFn fn = encode_im2col_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W, (cuuint64_t)a.H,
                              (cuuint64_t)a.batch};
  const cuuint64_t strides[3] = {2ull * a.C, 2ull * a.C * a.W, 2ull * a.C * a.W * a.H};
  const int lo[2] = {a.lo_w, a.lo_h};
  const int hi[2] = {a.hi_w, a.hi_h};
  const cuuint32_t elem[4] = {1, (cuuint32_t)a.stride, (cuuint32_t)a.stride, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<uint8_t*>(a.x), dims, strides,
            lo, hi, row / 2, pixels, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace cb
}  // namespace
