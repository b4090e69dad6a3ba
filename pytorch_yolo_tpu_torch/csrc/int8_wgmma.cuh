// The Hopper int8 implicit-GEMM core shared by K3 (gemm_i8.cu) and K4
// (int8_conv.cu): s8 x s8 -> s32 with wgmma from shared memory, a ring of
// shared-memory stages fed by TMA (and, for K4's gather, by cp.async), one
// producer warpgroup and two consumer warpgroups, one persistent block per
// SM, and an epilogue staged through shared memory.
//
// Problem: out[m, o] = sum_k A[m, k] * W[o, k] over k = (tap, channel), as in
// int8_igemm.cuh (the mma.sync core, which keeps the byte path: C or a group
// offset that is not a multiple of 16).  The epilogue's arithmetic is that
// core's, operation for operation, so every output equals the plain version
// bit for bit (int32 sums are exact in any order).
//
// What bounds it on an H100: K4 at yolov3's 3x3 widths does ~1500 int8 ops
// per byte moved and is bound by the tensor cores (1,979 TOPS) at 13x13 and
// by HBM (3.35 TB/s; the fp32 output is most of the bytes) at 52x52; K3's
// 1x1 convs (K = 256-1024) are bound by HBM.  The design answers both:
//   * wgmma.m64nBNk32.s32.s8.s8 from 128-byte-swizzled K-major tiles: a
//     128 x BN block tile (BN = 128 or 256), each consumer warpgroup 64 x BN;
//   * a ring of kStages stages of BK = 128 K bytes with a full and an empty
//     mbarrier per stage.  B (weights, (O, KH*KW*C)) and K3's A ((M, K), one
//     2-D map per channel group) arrive by TMA; K4's A is an implicit-GEMM
//     gather that stays a gather: the producer warpgroup issues 16-byte
//     cp.async copies straight into the swizzled layout, zero-filling
//     padding taps, rows past M and channels past the group's end, and
//     signals with cp.async.mbarrier.arrive.noinc;
//   * setmaxnreg moves registers from the producer (56) to the consumers
//     (224), whose int32 accumulators take BN / 2 registers a thread;
//   * persistent blocks walk tiles in an order that keeps the N-tiles of one
//     M-tile together (A is read from HBM once), and a warpgroup's epilogue
//     of tile i overlaps the producer's loads for tile i + 1;
//   * the epilogue stages 32-column chunks of raw accumulators in shared
//     memory, then each thread turns four columns of one output row into
//     outputs and writes them with one store (16 bytes of int32 or fp32, 4
//     of int8), eight threads to a row's 32 columns.  The store loop is
//     compiled once per (mode, activation) and chosen once per chunk:
//     switched per element, the two switches compiled to indirect jumps
//     that cost 2-3x the whole kernel's time at fp32 out.  At fp32 out a
//     Darknet [shortcut] operand, when given, is read with the same
//     pieces (16 bytes of fp32 or 8 of bf16 a row's four) and added after
//     the activation, so the separate add's 8 bytes read and 4 written an
//     element become 4 (or 2) read.
// The K loop walks (channel group, tap, 128-byte slice), so a split-concat
// conv keeps one int32 sum per group and folds it into fp32 at the group's
// last slice in the plain version's order; the next group's first wgmma
// starts from zero (scale-d = 0).  Scales are device pointers read in the
// kernel, so no conv syncs the host.
//
// What holds it back (measured on an H100 SXM at 700 W, PERF.md): K3
// reaches ~75 % of its HBM bound.  K4's 16-byte gather costs ~1.05 us per
// 128-byte K slice against ~0.7 us for the same slice by TMA; TMA's im2col
// mode is the remedy.  Shared memory serves ~128 KB per slice (both
// warpgroups read the whole B tile), near its ~128 B/clock, which caps a
// slice near 0.6 us.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_guard.cuh"
#include "int8_igemm.cuh"

namespace {
namespace wg {

constexpr int kBM = 128;           // block tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;           // K bytes per stage: one 128-byte swizzle row
constexpr int kThreads = 384;      // warpgroup 0 loads, warpgroups 1 and 2 compute
// Registers a thread after setmaxnreg.  The kernel starts at 168 (65,536 /
// 384, rounded down to 8); the consumers' increase must not exceed what the
// producer frees, 128 * (168 - 56) = 256 * (224 - 168), or setmaxnreg.inc
// waits for registers that never come and the kernel hangs.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(128 * (168 - kProducerRegs) >= 256 * (kConsumerRegs - 168),
              "the consumers would wait forever for registers");
constexpr int kChunk = 32;         // epilogue columns staged at a time
constexpr int kStageRow = 160;     // staged row: 32 x 4 B + 32 B (conflict-free 8-byte writes)

template <int BN>
struct Layout {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kOffB = kStages * kABytes;
  static constexpr int kOffStaging = kOffB + kStages * kBBytes;            // 2 x 64 rows
  static constexpr int kOffParams = kOffStaging + 2 * 64 * kStageRow;      // 2 x 3 x BN fp32
  static constexpr int kOffRows = kOffParams + 2 * 3 * BN * 4;             // 128 RowInfo
  static constexpr int kOffBars = kOffRows + kBM * 16;                     // full, then empty
  static constexpr int kBytes = kOffBars + 2 * kStages * 8 + 1024;         // + alignment slack
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

// Kernel parameters, passed by value as one __grid_constant__: TMA needs the
// maps in parameter (or global) memory, never a host address.
struct Params {
  CUtensorMap tma_b;               // W as (O, KH*KW*C) int8
  CUtensorMap tma_a[kMaxGroups];   // K3: A's channel group g as (M, width_g), row stride K
  IgemmArgs a;
  int tiles_n, tiles;
};

// The gather's per-row state, computed once per tile by the producer.
struct __align__(16) RowInfo {
  long long base;  // offset of image n in x
  int ih0, iw0;    // top-left input pixel of the window; ih0 < -H marks a row past M
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrives on `bar` when this thread's earlier cp.async copies have landed;
// the arrival is one of the count the barrier was initialised with.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16_u32(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c_inner, int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma issue and wait (the asm below already names them as outputs).
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define YOLO_D8(i)                                                                    \
  "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),     \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define YOLO_D64(i)                                                                   \
  YOLO_D8(i + 0), YOLO_D8(i + 8), YOLO_D8(i + 16), YOLO_D8(i + 24), YOLO_D8(i + 32),  \
      YOLO_D8(i + 40), YOLO_D8(i + 48), YOLO_D8(i + 56)

// d (+)= A(64 x 32, smem) * B(BN x 32, smem)^T; scale_d = 0 starts from zero.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : YOLO_D64(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : YOLO_D64(0), YOLO_D64(64)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef YOLO_D64
#undef YOLO_D8

// The epilogue's scalars, copied once into registers.
struct Epi {
  char* out;
  long long M;
  int O, pre, mul, sh;
  bool vec_ok;
  const char* shortcut;  // the (M, O) [shortcut] operand at fp32 out, or null
  int sc_bytes;          // 4 (fp32) or 2 (bf16)
};

// One output of the fused epilogue (int8_igemm.cuh: igemm_kernel, the same
// operations in the same order), with the mode and activation fixed at
// compile time: switched per element they compile to indirect jumps that
// cost more than the arithmetic.  `mul`, `add`, `div` are the column's
// deq / bias / 1 (fp32 out, homogeneous int8 out: deq/os, bias/os, 1) or
// deq / bias / os (other int8 out).  With kSc (fp32 out) the [shortcut]
// operand `sc` is added after the activation (int8_igemm.cuh:
// activate_add).  Returns the int32 or fp32 bits, or the int8 in the low
// byte.
template <int kMode, int kAct, bool kSplit, bool kSc>
__device__ __forceinline__ uint32_t epilogue_one(const Epi& e, uint32_t raw, float mul, float add,
                                                 float div, float sc) {
  const int iacc = (int)raw;
  if constexpr (kMode == kEpiAcc) {
    return raw;
  } else if constexpr (kMode == kEpiFixed) {
    const int scaled = (iacc >> e.pre) * e.mul;
    const int y = iacc > 0 ? scaled >> e.sh : scaled >> (e.sh + 3);
    return (uint32_t)(uint8_t)(int8_t)min(max(y, -127), 127);
  } else {
    const float v = kSplit ? __uint_as_float(raw) : __int2float_rn(iacc);
    const float pre = __fmaf_rn(v, mul, add);
    if constexpr (kMode == kEpiF32)
      return __float_as_uint(kSc ? activate_add(pre, kAct, sc) : activate(pre, kAct));
    const float y = activate(pre, kAct);
    constexpr bool kHomogeneous = kAct == kLeaky || kAct == kRelu || kAct == kLinear;
    return (uint32_t)(uint8_t)requant(kHomogeneous ? y : __fdiv_rn(y, div));
  }
}

// The four shortcut values at element `idx` of the (M, O) operand (columns
// o0 .. o0 + 3 of a row), widened to fp32: one 16-byte (fp32) or 8-byte
// (bf16) load where the row's four are whole, else element by element.
__device__ __forceinline__ float4 shortcut4(const Epi& e, long long idx, int o0, bool whole) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (e.sc_bytes == 4) {
    const float* p = reinterpret_cast<const float*>(e.shortcut) + idx;
    if (whole) return __ldg(reinterpret_cast<const float4*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (o0 + i < e.O) s[i] = p[i];
  } else {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(e.shortcut) + idx;
    if (whole) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                         __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (o0 + i < e.O) s[i] = __uint_as_float((uint32_t)p[i] << 16);
  }
  return make_float4(s[0], s[1], s[2], s[3]);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b));
}

// Turns four staged columns of the warpgroup's rows row0, row0 + 16, ...
// (int32 sums, or fp32 group sums for a split conv) into outputs at
// columns o0 .. o0 + 3, and stores each row's four with one store: 16
// bytes (int32, fp32) or 4 bytes (int8) where the row is aligned and
// whole, else element by element.
template <int kMode, int kAct, bool kSplit, bool kShortcut>
__device__ __forceinline__ void store_rows(const Epi& e, uint32_t staging, int row0, long long m0,
                                        int o0, float4 mul, float4 add, float4 div) {
  constexpr bool kSc = kShortcut && kMode == kEpiF32;
  constexpr int kOut = (kMode == kEpiAcc || kMode == kEpiF32) ? 4 : 1;
  const bool whole = e.vec_ok && o0 + 4 <= e.O;
  // One row: its four outputs from the staged sums, stored; false past M.
  auto one_row = [&](int row, float4 sc) {
    const long long m = m0 + row;
    if (m >= e.M) return false;
    const uint4 raw = lds128(staging + row * kStageRow);
    const uint32_t y0 = epilogue_one<kMode, kAct, kSplit, kSc>(e, raw.x, mul.x, add.x, div.x, sc.x);
    const uint32_t y1 = epilogue_one<kMode, kAct, kSplit, kSc>(e, raw.y, mul.y, add.y, div.y, sc.y);
    const uint32_t y2 = epilogue_one<kMode, kAct, kSplit, kSc>(e, raw.z, mul.z, add.z, div.z, sc.z);
    const uint32_t y3 = epilogue_one<kMode, kAct, kSplit, kSc>(e, raw.w, mul.w, add.w, div.w, sc.w);
    char* dst = e.out + (m * e.O + o0) * kOut;
    if (kOut == 4) {
      if (whole) {
        asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "r"(y0), "r"(y1),
                     "r"(y2), "r"(y3));
      } else {
        const uint32_t y[4] = {y0, y1, y2, y3};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (o0 + i < e.O) reinterpret_cast<uint32_t*>(dst)[i] = y[i];
      }
    } else {
      const uint32_t word =
          (y0 & 0xFF) | (y1 & 0xFF) << 8 | (y2 & 0xFF) << 16 | (y3 & 0xFF) << 24;
      if (whole) {
        asm volatile("st.global.b32 [%0], %1;\n" ::"l"(dst), "r"(word));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (o0 + i < e.O) dst[i] = (char)((word >> (8 * i)) & 0xFF);
      }
    }
    return true;
  };
  if constexpr (kSc) {
    // the operand of the thread's four rows, loaded together (from L2: the
    // tile prefetched it, prefetch_shortcut), so their latencies overlap
    float4 scs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long m = m0 + row0 + 16 * j;
      scs[j] = m < e.M ? shortcut4(e, m * e.O + o0, o0, whole)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!one_row(row0 + 16 * j, scs[j])) break;
  } else {
#pragma unroll 1
    for (int row = row0; row < 64; row += 16)
      if (!one_row(row, make_float4(0.0f, 0.0f, 0.0f, 0.0f))) break;
  }
}

// Asks L2 for the [shortcut] operand of a warpgroup's 64 rows from m0 and
// columns n0 .. n0 + bn - 1, one 128-byte line a request spread over its
// 128 threads, at the start of the tile: by the epilogue the lines are in
// L2, and its loads wait for L2 instead of HBM.
__device__ __forceinline__ void prefetch_shortcut(const IgemmArgs& a, long long m0, int n0, int bn,
                                                  int tid) {
  const int esize = a.shortcut_bf16 ? 2 : 4;
  const int cols = min(bn, a.O - n0);
  const int per_row = (cols * esize + 127) / 128 + 1;  // + 1: rows need not start on a line
  for (int i = tid; i < 64 * per_row; i += 128) {
    const int r = i / per_row;
    const long long m = m0 + r;
    if (m >= a.M) break;
    const uintptr_t row = reinterpret_cast<uintptr_t>(a.shortcut) + (m * a.O + n0) * esize;
    const uintptr_t line = (row & ~(uintptr_t)127) + (uintptr_t)(i - r * per_row) * 128;
    if (line < row + (uintptr_t)cols * esize)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
  }
}

// store_rows for the call's mode and activation: one dispatch per chunk.
template <bool kSplit, bool kShortcut>
__device__ __forceinline__ void store_rows_for(int mode, int act, const Epi& e, uint32_t staging,
                                               int row0, long long m0, int o0, float4 mul,
                                               float4 add, float4 div) {
#define YOLO_ACTS(MODE)                                                                  \
  switch (act) {                                                                         \
    case kLeaky:                                                                         \
      return store_rows<MODE, kLeaky, kSplit, kShortcut>(e, staging, row0, m0, o0, mul,  \
                                                         add, div);                      \
    case kMish:                                                                          \
      return store_rows<MODE, kMish, kSplit, kShortcut>(e, staging, row0, m0, o0, mul,   \
                                                        add, div);                       \
    case kRelu:                                                                          \
      return store_rows<MODE, kRelu, kSplit, kShortcut>(e, staging, row0, m0, o0, mul,   \
                                                        add, div);                       \
    case kLogistic:                                                                      \
      return store_rows<MODE, kLogistic, kSplit, kShortcut>(e, staging, row0, m0, o0,    \
                                                            mul, add, div);              \
    default:                                                                             \
      return store_rows<MODE, kLinear, kSplit, kShortcut>(e, staging, row0, m0, o0, mul, \
                                                          add, div);                     \
  }
  switch (mode) {
    case kEpiAcc:
      return store_rows<kEpiAcc, kLinear, kSplit, false>(e, staging, row0, m0, o0, mul, add,
                                                         div);
    case kEpiFixed:
      return store_rows<kEpiFixed, kLinear, kSplit, false>(e, staging, row0, m0, o0, mul, add,
                                                           div);
    case kEpiF32:
      YOLO_ACTS(kEpiF32)
    default:
      YOLO_ACTS(kEpiI8)
  }
#undef YOLO_ACTS
}

// The epilogue's factors (mul, add, div) of output channel `o` for
// epilogue_one: the dequant `sx * ws[o]` (or ws[o] alone where `sx` is
// null) and the bias; at int8 out with leaky, relu or linear both divided
// by the out_scale (divide first, activate after), with any other
// activation the out_scale as the divisor (activate at the true scale,
// then divide).  (0, 0, 1) past O and in the accumulator and fixed modes.
__device__ __forceinline__ float3 epilogue_column(const IgemmArgs& a, int o, float sx,
                                                  float os_scalar, bool homogeneous) {
  float mul = 0.0f, add = 0.0f, div = 1.0f;
  if (a.mode >= kEpiF32 && o < a.O) {
    const float deq = a.sx != nullptr ? __fmul_rn(sx, a.ws[o]) : a.ws[o];
    const float bias = a.bias[o];
    mul = deq;
    add = bias;
    if (a.mode == kEpiI8) {
      const float os = a.out_scale_vec ? a.out_scale[o] : os_scalar;
      if (homogeneous) {
        mul = __fdiv_rn(deq, os);
        add = __fdiv_rn(bias, os);
      } else {
        div = os;
      }
    }
  }
  return make_float3(mul, add, div);
}

// Writes the 32 columns [32 CH, 32 CH + 32) of a consumer warpgroup's
// accumulators (split convs: the fp32 group sums, times sxg[0] for a single
// group) to its staging rows at shared address `staging`.  acc[4j + 2h + e]
// holds row 16 warp + lane/4 + 8h, column 8j + 2(lane%4) + e.
template <int CH, bool kSplit, int N, int NF>
__device__ __forceinline__ void stage_chunk(const int (&acc)[N], const float (&facc)[NF],
                                            bool scale_one_group, float g1, uint32_t staging,
                                            int warp, int lane) {
#pragma unroll
  for (int jj = 0; jj < kChunk / 8; ++jj) {
    const int j = CH * (kChunk / 8) + jj;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h;
      uint32_t w0, w1;
      if constexpr (kSplit) {
        const float v0 = facc[4 * j + 2 * h], v1 = facc[4 * j + 2 * h + 1];
        w0 = __float_as_uint(scale_one_group ? __fmul_rn(v0, g1) : v0);
        w1 = __float_as_uint(scale_one_group ? __fmul_rn(v1, g1) : v1);
      } else {
        w0 = (uint32_t)acc[4 * j + 2 * h];
        w1 = (uint32_t)acc[4 * j + 2 * h + 1];
      }
      sts64(staging + row * kStageRow + (8 * jj + 2 * (lane % 4)) * 4, w0, w1);
    }
  }
}

// kShortcut: the call passes a [shortcut] operand (fp32 out).  A separate
// instantiation, so that a conv without one compiles as if the operand did
// not exist: its registers, at BN = 256 close to the 168 ptxas allows a
// thread of the 384-thread block, are not touched.
template <bool kGather, bool kSplit, int BN, bool kShortcut>
__global__ void __launch_bounds__(kThreads, 1) wgmma_kernel(__grid_constant__ const Params p) {
  using L = Layout<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full0 = base + L::kOffBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  const IgemmArgs& a = p.a;
  const int taps = a.KH * a.KW;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: the TMA thread's expect_tx arrival (+ 128 cp.async arrivals for
      // the gather); empty: lane 0 of each of the 8 consumer warps.
      mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int total = 0;  // K steps per tile
  for (int g = 0; g < a.groups; ++g)
    total += taps * ((a.goff[g + 1] - a.goff[g] + kBK - 1) / kBK);

  if (role == 0) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (!kGather && tid != 0) return;  // K3: one thread issues every TMA load
    RowInfo* rows = reinterpret_cast<RowInfo*>(smem + L::kOffRows);
    const int chunk = tid & 7;                          // 16-byte chunk of a 128-byte row
    const uint32_t swz = (uint32_t)((chunk ^ ((tid >> 3) & 7)) * 16);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.tiles_n) * kBM;
      const int n0 = (t % p.tiles_n) * BN;
      if constexpr (kGather) {
        named_barrier(3, 128);  // every producer thread is done with the last tile's rows
        const int m = m0 + tid;
        RowInfo e;
        if (m < a.M) {
          const int hw = a.Ho * a.Wo;
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
        named_barrier(3, 128);
      }
      KStep k = {0, 0, a.goff[0]};
      for (int i = 0; i < total; ++i) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t sa = base + stage * L::kABytes;
        const uint32_t sb = base + L::kOffB + stage * L::kBBytes;
        if (tid == 0) {
          mbar_arrive_expect_tx(full, kGather ? L::kBBytes : L::kABytes + L::kBBytes);
          // B past a group's end multiplies zero-filled (K4) or zero (K3) A.
          tma_load_2d(sb, &p.tma_b, full, k.tap * a.C + k.c0, n0);
          if (!kGather) tma_load_2d(sa, &p.tma_a[k.g], full, k.c0 - a.goff[k.g], m0);
        }
        if constexpr (kGather) {
          const int r = k.tap / a.KW;
          const int s = k.tap - r * a.KW;
          const int c = k.c0 + chunk * 16;
          const bool c_in = c < a.goff[k.g + 1];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int row = (tid >> 3) + 16 * j;
            const RowInfo e = rows[row];
            const int ih = e.ih0 + r;
            const int iw = e.iw0 + s;
            const bool ok = c_in && (unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W;
            const int8_t* src = ok ? a.x + e.base + ((long long)ih * a.W + iw) * a.C + c : a.x;
            cp_async16_u32(sa + row * kBK + swz, src, ok ? 16 : 0);
          }
          cp_async_arrive_noinc(full);
        }
        advance(k, a, taps, kBK);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = role - 1;  // rows [64 cw, 64 cw + 64) of the block tile
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + L::kOffStaging + cw * 64 * kStageRow;
    float* prm = reinterpret_cast<float*>(smem + L::kOffParams) + cw * 3 * BN;
    const uint32_t prm_addr = smem_u32(prm);
    const float sx = (a.mode >= kEpiF32 && a.sx != nullptr) ? *a.sx : 1.0f;
    const float os_scalar = (a.mode == kEpiI8 && !a.out_scale_vec) ? *a.out_scale : 1.0f;
    const bool homogeneous = a.act == kLeaky || a.act == kRelu || a.act == kLinear;
    const int out_bytes = (a.mode == kEpiAcc || a.mode == kEpiF32) ? 4 : 1;
    const Epi epi = {static_cast<char*>(a.out), a.M, a.O, a.pre, a.mul, a.sh,
                     ((long long)a.O * out_bytes) % 16 == 0,
                     kShortcut ? static_cast<const char*>(a.shortcut) : nullptr,
                     a.shortcut_bf16 ? 2 : 4};
    const int mode = a.mode, act = a.act;

    int acc[BN / 2];
    float facc[kSplit ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < (kSplit ? BN / 2 : 1); ++i) facc[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.tiles_n) * kBM;
      const int n0 = (t % p.tiles_n) * BN;
      if constexpr (kShortcut) prefetch_shortcut(a, m0 + 64 * cw, n0, BN, tid);
      KStep k = {0, 0, a.goff[0]};
      bool first = true;  // the next wgmma starts a sum: scale-d = 0
      for (int i = 0; i < total; ++i) {
        mbar_wait(full0 + 8 * stage, phase);
        // cp.async wrote the gathered A through the generic proxy; wgmma
        // reads through the async proxy.
        if (kGather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = base + stage * L::kABytes + cw * 64 * kBK;
        const uint32_t sb = base + L::kOffB + stage * L::kBBytes;
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_s8<BN>(acc, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk),
                       (first && kk == 0) ? 0 : 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        first = false;
        if constexpr (kSplit) {
          const int g = k.g;
          advance(k, a, taps, kBK);
          if (k.g != g) {  // the group's last slice: fold its int32 sum into fp32
            // ops/kernels.py: _split_sum's order: group 0's sum waits
            // unscaled, group 1 adds fma(sum0, s0, sum1 * s1), and each
            // later group adds fma(sum_g, s_g, running sum).
            const float sg = a.sxg[g];
            const float s0 = a.sxg[0];
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) {
              const float sum = __int2float_rn(acc[j]);
              facc[j] = g == 0   ? sum
                        : g == 1 ? __fmaf_rn(facc[j], s0, __fmul_rn(sum, sg))
                                 : __fmaf_rn(sum, sg, facc[j]);
            }
            first = true;
          }
        }
      }

      // Epilogue.  Column parameters for the tile, then 32-column chunks:
      // stage the raw sums, then turn them into outputs four columns a thread.
      named_barrier(bar_id, 128);  // the last tile's pieces are written
      for (int c = tid; c < BN; c += 128) {
        const float3 f = epilogue_column(a, n0 + c, sx, os_scalar, homogeneous);
        prm[c] = f.x;
        prm[BN + c] = f.y;
        prm[2 * BN + c] = f.z;
      }
      const float g1 = kSplit && a.groups == 1 ? a.sxg[0] : 1.0f;
      // The chunk loop stays rolled (one copy of the store loops); only the
      // register-to-staging write is specialised per chunk, since register
      // arrays take constant indices only.
#pragma unroll 1
      for (int ch = 0; ch < BN / kChunk; ++ch) {
        if (n0 + ch * kChunk >= a.O) break;  // uniform over the warpgroup
        if (ch > 0) named_barrier(bar_id, 128);  // the last chunk's pieces are written
        switch (ch) {
#define YOLO_STAGE(CH)                                                                   \
  case CH:                                                                               \
    if constexpr (CH < BN / kChunk)                                                      \
      stage_chunk<CH, kSplit>(acc, facc, a.groups == 1, g1, staging, warp, lane);        \
    break;
          YOLO_STAGE(0) YOLO_STAGE(1) YOLO_STAGE(2) YOLO_STAGE(3)
          YOLO_STAGE(4) YOLO_STAGE(5) YOLO_STAGE(6) YOLO_STAGE(7)
#undef YOLO_STAGE
        }
        named_barrier(bar_id, 128);
        // 8 pieces of 4 columns per staged row; a quarter-warp reads one row.
        const int q = tid % 8;
        const int col = ch * kChunk + 4 * q;
        const int o0 = n0 + col;
        if (o0 < epi.O) {
          const uint4 mu = lds128(prm_addr + 4 * col);
          const uint4 ad = lds128(prm_addr + 4 * (BN + col));
          const uint4 dv = lds128(prm_addr + 4 * (2 * BN + col));
          const float4 mul = make_float4(__uint_as_float(mu.x), __uint_as_float(mu.y),
                                         __uint_as_float(mu.z), __uint_as_float(mu.w));
          const float4 add = make_float4(__uint_as_float(ad.x), __uint_as_float(ad.y),
                                         __uint_as_float(ad.z), __uint_as_float(ad.w));
          const float4 div = make_float4(__uint_as_float(dv.x), __uint_as_float(dv.y),
                                         __uint_as_float(dv.z), __uint_as_float(dv.w));
          store_rows_for<kSplit, kShortcut>(mode, act, epi, staging + 16 * q, tid / 8,
                                 (long long)m0 + 64 * cw, o0, mul, add, div);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// needs no -lcuda at link.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 2-D int8 map over (rows, cols) with row stride `pitch` bytes, loaded in
// boxes of 128 K bytes x box_rows rows with 128-byte swizzle; out-of-bounds
// elements read as zero.
inline bool encode_2d(CUtensorMap* map, const void* ptr, long long cols, long long rows,
                      long long pitch, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool kGather, bool kSplit, int BN, bool kShortcut>
cudaError_t launch_one(const Params& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  auto kernel = wgmma_kernel<kGather, kSplit, BN, kShortcut>;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {  // once per instantiation and device
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<BN>::kBytes);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, kThreads, Layout<BN>::kBytes, s>>>(p);
  return cudaGetLastError();
}

// Launches the wgmma core on `stream` with a BN-column tile (128 or 256;
// split convs take 128); returns a CUDA error code (0 = ok).  The caller
// has checked that C and every group offset are multiples of 16 and that x
// and w are 16-byte aligned.
template <bool kGather>
int launch_wgmma(const IgemmArgs* args, int bn, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaSuccess;
  const IgemmArgs& a = *args;
  const bool split = a.sxg != nullptr;
  if (a.groups < 1 || a.groups > kMaxGroups || (bn != 128 && bn != 256) || (split && bn != 128))
    return (int)cudaErrorInvalidValue;
  if (a.M == 0 || a.O == 0) return 0;
  Params p{};
  p.a = a;
  const long long k = (long long)a.KH * a.KW * a.C;
  if (!encode_2d(&p.tma_b, a.w, k, a.O, k, bn)) return (int)cudaErrorInvalidValue;
  if (!kGather) {
    for (int g = 0; g < a.groups; ++g)
      if (!encode_2d(&p.tma_a[g], a.x + a.goff[g], a.goff[g + 1] - a.goff[g], a.M, a.C, kBM))
        return (int)cudaErrorInvalidValue;
  }
  p.tiles_n = (a.O + bn - 1) / bn;
  p.tiles = ((a.M + kBM - 1) / kBM) * p.tiles_n;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.shortcut != nullptr) {
    if (split) return (int)launch_one<kGather, true, 128, true>(p, device, sms, s);
    if (bn == 256) return (int)launch_one<kGather, false, 256, true>(p, device, sms, s);
    return (int)launch_one<kGather, false, 128, true>(p, device, sms, s);
  }
  if (split) return (int)launch_one<kGather, true, 128, false>(p, device, sms, s);
  if (bn == 256) return (int)launch_one<kGather, false, 256, false>(p, device, sms, s);
  return (int)launch_one<kGather, false, 128, false>(p, device, sms, s);
}

}  // namespace wg
}  // namespace
