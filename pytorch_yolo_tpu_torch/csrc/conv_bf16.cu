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
// (C = 3, 32 outputs, 416x416) are bound by HBM.  The design is the int8
// core's (int8_wgmma.cuh), whose helpers it uses:
//   * wgmma.m64nNk16.f32.bf16.bf16 from 128-byte-swizzled K-major tiles:
//     a 128 x BN block tile (BN = 64, 128 or 256), each of the two consumer
//     warpgroups 64 x BN; a 256-column tile runs as two n128 halves on the
//     same A stage, so a conv with 256 or more outputs gathers its A once;
//   * two-level accumulation: the tensor cores sum one stage's 64 products
//     of K into a fresh register set, and the consumer adds that partial
//     sum into the tile's fp32 sums with __fadd_rn.  The tensor cores' own
//     fp32 accumulation is not an IEEE sum: measured on an H100 against the
//     float64 sum rounded once, chaining every stage in the accumulators
//     gave 99.70 % equal bf16 outputs at K = 4608, where cuDNN's fp32 conv
//     gave 99.95 %, and the two-level sum 99.98 % (PERF.md).  The
//     partial set is one n128 half (64 registers) beside the tile's sums;
//   * a ring of stages of 64 bf16 of K (one 128-byte swizzle row) with a
//     full and an empty mbarrier each.  The weights arrive by TMA as an
//     (O, K) matrix; a 1x1 stride-1 conv's A arrives by TMA as the (M, C)
//     matrix it is; every other conv's A is gathered by the producer
//     warpgroup with 16-byte cp.async copies (8 channels of one pixel),
//     zero-filling padding taps, rows past M and K past its end;
//   * K is walked flat, 64 at a time, so a stage may hold several taps: a
//     conv with C = 32 takes 5 stages of K = 288, not 9, and the RGB stem,
//     its channels padded to 8 by the wrapper, 2 stages of K = 72;
//   * the epilogue stages 32-column chunks of fp32 sums in shared memory;
//     each thread then turns four columns of one row into bf16 outputs,
//     __fadd_rn(sum, bias), the activation of int8_igemm.cuh (the JAX
//     formulas), __float2bfloat16_rn, and writes them with one 8-byte store.
//     The store loop is compiled once per (activation, shortcut).
// The result equals the plain version (ops/kernels.py: conv_bf16_ref, an
// fp32 conv of the same bf16 operands) up to the order of the fp32 sums:
// a bf16 output differs only where those sums straddle a rounding boundary.

#include <cuda_bf16.h>

#include "int8_igemm.cuh"
#include "int8_wgmma.cuh"

namespace {
namespace cb {

constexpr int kStageK = wg::kBK / 2;  // bf16 of K a stage: one 128-byte swizzle row

// Mirrors ops/kernels.py: _ConvBf16Args (ctypes).  Pointers first, then ints.
struct ConvBf16Args {
  const uint8_t* x;         // NHWC bf16 (batch, H, W, C), C % 8 == 0
  const uint8_t* w;         // (O, KH, KW, C) bf16
  const float* bias;        // (O,) fp32
  const uint8_t* shortcut;  // (M, O) bf16 added after the rounding, or null
  uint8_t* out;             // (M, O) bf16
  int batch, H, W, C, Ho, Wo, O, KH, KW, stride, pad, M, act;
};

// Kernel parameters, passed by value as one __grid_constant__ (TMA needs
// the maps in parameter or global memory).
struct Params {
  CUtensorMap tma_b;  // W as (O, K) bf16, addressed in bytes
  CUtensorMap tma_a;  // 1x1 stride-1 convs: x as (M, C) bf16
  ConvBf16Args a;
  int tiles_n, tiles, ksteps;
};

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

template <bool kGather, int BN>
__global__ void __launch_bounds__(wg::kThreads, 1) conv_bf16_kernel(__grid_constant__ const Params p) {
  using L = wg::Layout<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw_addr);
  const uint32_t full0 = base + L::kOffBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  const ConvBf16Args& a = p.a;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: the TMA thread's expect_tx arrival (+ 128 cp.async arrivals for
      // the gather); empty: lane 0 of each of the 8 consumer warps.
      wg::mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      wg::mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 0) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::kProducerRegs));
    if (!kGather && tid != 0) return;  // one thread issues every TMA load
    wg::RowInfo* rows = reinterpret_cast<wg::RowInfo*>(smem + L::kOffRows);
    const int chunk = tid & 7;  // 16-byte chunk (8 channels) of a 128-byte row
    const uint32_t swz = (uint32_t)((chunk ^ ((tid >> 3) & 7)) * 16);
    const int taps = a.KH * a.KW;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.tiles_n) * wg::kBM;
      const int n0 = (t % p.tiles_n) * BN;
      if constexpr (kGather) {
        wg::named_barrier(3, 128);  // every producer thread is done with the last tile's rows
        const int m = m0 + tid;
        wg::RowInfo e;
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
        wg::named_barrier(3, 128);
      }
      for (int s = 0; s < p.ksteps; ++s) {
        wg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t sa = base + stage * L::kABytes;
        const uint32_t sb = base + L::kOffB + stage * L::kBBytes;
        if (tid == 0) {
          wg::mbar_arrive_expect_tx(full, kGather ? L::kBBytes : L::kABytes + L::kBBytes);
          // K past its end reads as zero (TMA's out-of-bounds fill).
          wg::tma_load_2d(sb, &p.tma_b, full, s * wg::kBK, n0);
          if (!kGather) wg::tma_load_2d(sa, &p.tma_a, full, s * wg::kBK, m0);
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::kConsumerRegs));
    const int cw = role - 1;  // rows [64 cw, 64 cw + 64) of the block tile
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + L::kOffStaging + cw * 64 * wg::kStageRow;
    float* prm = reinterpret_cast<float*>(smem + L::kOffParams) + cw * 3 * BN;
    const uint32_t prm_addr = wg::smem_u32(prm);
    const bool vec_ok = a.O % 4 == 0;  // a row of bf16 outputs is 8-byte aligned

    constexpr int kHalf = BN < 128 ? BN : 128;  // columns of one MMA pass
    float acc[BN / 2];      // the tile's fp32 sums
    float part[kHalf / 2];  // one stage's sums of one pass, from the tensor cores
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) part[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.tiles_n) * wg::kBM;
      const int n0 = (t % p.tiles_n) * BN;
      for (int s = 0; s < p.ksteps; ++s) {
        wg::mbar_wait(full0 + 8 * stage, phase);
        // cp.async wrote the gathered A through the generic proxy; wgmma
        // reads through the async proxy.
        if (kGather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = base + stage * L::kABytes + cw * 64 * wg::kBK;
        const uint32_t sb = base + L::kOffB + stage * L::kBBytes;
#pragma unroll
        for (int h = 0; h < BN / kHalf; ++h) {  // B rows [h kHalf, (h + 1) kHalf)
          const uint32_t sbh = sb + h * kHalf * wg::kBK;
          wg::wgmma_fence();
          fence_f(part);
#pragma unroll
          for (int kk = 0; kk < wg::kBK / 32; ++kk)
            wgmma_bf16<kHalf>(part, wg::sw128_desc(sa + 32 * kk), wg::sw128_desc(sbh + 32 * kk),
                              kk == 0 ? 0 : 1);
          wg::wgmma_commit();
          wg::wgmma_wait_all();
          fence_f(part);
          // the pass's fragment is columns [h kHalf, (h + 1) kHalf) of the tile's
#pragma unroll
          for (int i = 0; i < kHalf / 2; ++i) {
            float& a = acc[h * (kHalf / 2) + i];
            a = s == 0 ? part[i] : __fadd_rn(a, part[i]);
          }
        }
        if (lane == 0) wg::mbar_arrive(empty0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
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
}

template <bool kGather, int BN>
cudaError_t launch_one(const Params& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  auto kernel = conv_bf16_kernel<kGather, BN>;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {  // once per instantiation and device
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::Layout<BN>::kBytes);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, wg::kThreads, wg::Layout<BN>::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <bool kGather>
cudaError_t launch_bn(const Params& p, int bn, int device, int sms, cudaStream_t s) {
  if (bn == 64) return launch_one<kGather, 64>(p, device, sms, s);
  if (bn == 128) return launch_one<kGather, 128>(p, device, sms, s);
  return launch_one<kGather, 256>(p, device, sms, s);
}

}  // namespace cb
}  // namespace

// Launches K5 on `stream` with a `bn`-column tile (64, 128 or 256) and A by
// TMA (`tma_a` = 1: a 1x1 stride-1 unpadded conv) or by the gather; returns
// a CUDA error code (0 = ok).  `args` points to a ConvBf16Args
// (ops/kernels.py: _ConvBf16Args).  Requires C % 8 == 0 and x, w, shortcut
// and out 16-byte aligned (ops/kernels.py: conv_bf16 checks and pads).
extern "C" int yolo_conv_bf16(const void* args, int bn, int tma_a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cb::ConvBf16Args& a = *static_cast<const cb::ConvBf16Args*>(args);
  if (a.C % 8 != 0 || (bn != 64 && bn != 128 && bn != 256) ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      reinterpret_cast<uintptr_t>(a.out) % 16 || reinterpret_cast<uintptr_t>(a.shortcut) % 16 ||
      (tma_a && (a.KH != 1 || a.KW != 1 || a.stride != 1 || a.pad != 0)))
    return (int)cudaErrorInvalidValue;
  if (a.M == 0 || a.O == 0) return 0;
  cb::Params p{};
  p.a = a;
  const long long k = (long long)a.KH * a.KW * a.C;
  if (!wg::encode_2d(&p.tma_b, a.w, 2 * k, a.O, 2 * k, bn)) return (int)cudaErrorInvalidValue;
  if (tma_a && !wg::encode_2d(&p.tma_a, a.x, 2LL * a.C, a.M, 2LL * a.C, wg::kBM))
    return (int)cudaErrorInvalidValue;
  p.ksteps = (int)((k + cb::kStageK - 1) / cb::kStageK);
  p.tiles_n = (a.O + bn - 1) / bn;
  p.tiles = ((a.M + wg::kBM - 1) / wg::kBM) * p.tiles_n;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(tma_a ? cb::launch_bn<false>(p, bn, device, sms, s)
                     : cb::launch_bn<true>(p, bn, device, sms, s));
}
