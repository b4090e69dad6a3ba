// The mma.sync int8 implicit-GEMM core shared by K3 (gemm_i8.cu) and K4
// (int8_conv.cu): s8 x s8 -> s32 on the tensor cores, then one fused
// epilogue per output element.  int8_wgmma.cuh is the Hopper core that runs
// every call whose C and group offsets are multiples of 16; this one keeps
// the byte path (C or a group width not a multiple of 16, such as an int8
// RGB stem) and is the baseline the wgmma core is timed against.
//
// Problem: out[m, o] = sum_k A[m, k] * W[o, k] over k = (tap, channel),
//   A = the NHWC int8 input, gathered per output pixel m = (n, oh, ow) and
//       tap (r, s) with Darknet's zero padding (K4), or read straight as an
//       (M, K) row-major matrix (K3);
//   W = the (O, KH, KW, C) int8 kernel, K contiguous per output channel.
//
// Design (simple and right first):
//   * a 128 x 128 output tile per block of 8 warps (2 x 4), each warp
//     64 x 32 as 4 x 4 mma.sync.m16n8k32 s8 tiles, int32 accumulators in
//     registers;
//   * 64-byte K slices staged in shared memory, two stages, with 16-byte
//     cp.async copies that zero-fill padding taps and ragged M/N/K edges
//     (a byte path covers channel counts that are not multiples of 16,
//     such as the RGB input); rows are padded to 80 bytes so the
//     fragment loads of a warp hit 32 distinct banks;
//   * the K loop walks (channel group, tap, 64-channel slice), so a
//     split-concat conv keeps one int32 sum per group: at a group's end it
//     is scaled by the group's sxg[g] and added into an fp32 sum, in the
//     plain version's order;
//   * the epilogue follows quant.py:600-622 (JAX) as written: dequant
//     (sx * ws[o], or ws[o] alone for a per-channel grid or a split conv),
//     bias, activation, and optionally requant to int8 at a scalar or
//     per-channel out_scale.  Every multiply-add is one explicit __fmaf_rn,
//     as XLA compiles the JAX epilogue and as the plain version computes it
//     (ops/kernels.py: fma); every other product, sum and quotient is an
//     _rn intrinsic, so nvcc contracts nothing on its own.  Rounding is
//     rintf (half to even, as torch.round and jnp.round).  expf, log1pf and
//     tanhf are the CUDA math library's, as torch's own kernels use.
//   * every scale is read from device memory (a dynamic sx is a device
//     tensor), so no conv syncs the host.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 4;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kRowBytes = kBK + 16;  // padded shared-memory row
constexpr int kThreads = 256;

enum EpilogueMode { kEpiAcc = 0, kEpiFixed = 1, kEpiF32 = 2, kEpiI8 = 3 };
enum Activation { kLinear = 0, kLeaky = 1, kMish = 2, kRelu = 3, kLogistic = 4 };

// Mirrors ops/kernels.py: _IgemmArgs (ctypes).  Pointers first, then ints.
struct IgemmArgs {
  const int8_t* x;          // NHWC (batch, H, W, C); K3 passes (M, 1, 1, K)
  const int8_t* w;          // (O, KH, KW, C)
  void* out;                // (M, O): int32, int8 or fp32
  const float* sx;          // device scalar input scale, or null (deq = ws)
  const float* sxg;         // device per-group scales (split conv), or null
  const float* ws;          // (O,) per-output-channel weight scales
  const float* bias;        // (O,)
  const float* out_scale;   // device scalar or (O,) requant scale
  int batch, H, W, C, Ho, Wo, O, KH, KW, stride, pad, M;
  int groups;
  int goff[kMaxGroups + 1];  // channel offsets of the groups, goff[0] = 0
  int mode, act, out_scale_vec;
  int pre, mul, sh;          // fixed-point requant (the probe's epilogue)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kLeaky:
      return y > 0.0f ? y : __fmul_rn(y, 0.1f);
    case kMish: {  // y * tanh(log1p(exp(-|y|)) + max(y, 0))
      const float sp = __fadd_rn(log1pf(expf(-fabsf(y))), fmaxf(y, 0.0f));
      return __fmul_rn(y, tanhf(sp));
    }
    case kRelu:
      return fmaxf(y, 0.0f);
    case kLogistic:
      return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
    default:
      return y;
  }
}

__device__ __forceinline__ int8_t requant(float y) {
  return (int8_t)(int)fminf(fmaxf(rintf(y), -127.0f), 127.0f);
}

// One step of the K loop: channel group g, tap (r, s), channels [c0, c0 + step).
struct KStep {
  int g, tap, c0;
};

__device__ __forceinline__ void advance(KStep& k, const IgemmArgs& a, int taps,
                                        int step = kBK) {
  k.c0 += step;
  if (k.c0 >= a.goff[k.g + 1]) {
    k.c0 = a.goff[k.g];
    if (++k.tap == taps) {
      k.tap = 0;
      ++k.g;
      k.c0 = a.goff[k.g];
    }
  }
}

template <bool kConv, bool kSplit, bool kVec>
__global__ void __launch_bounds__(kThreads) igemm_kernel(const IgemmArgs a) {
  __shared__ __align__(16) int8_t sA[2][kBM * kRowBytes];
  __shared__ __align__(16) int8_t sB[2][kBN * kRowBytes];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int taps = a.KH * a.KW;

  // The two A rows and two B rows this thread stages, 16 bytes of each.
  const int chunk = (tid & 3) * 16;
  const int8_t* a_base[2];
  int a_ih[2], a_iw[2];
  bool a_ok[2];
  const int8_t* b_base[2];
  bool b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + 64 * i;
    const int m = m0 + row;
    a_ok[i] = m < a.M;
    const int mm = a_ok[i] ? m : 0;
    if (kConv) {
      const int hw = a.Ho * a.Wo;
      const int n = mm / hw;
      const int rem = mm - n * hw;
      const int oh = rem / a.Wo;
      const int ow = rem - oh * a.Wo;
      a_base[i] = a.x + (long long)n * a.H * a.W * a.C;
      a_ih[i] = oh * a.stride - a.pad;
      a_iw[i] = ow * a.stride - a.pad;
    } else {
      a_base[i] = a.x + (long long)mm * a.C;
      a_ih[i] = a_iw[i] = 0;
    }
    const int o = n0 + row;
    b_ok[i] = o < a.O;
    b_base[i] = a.w + (long long)(b_ok[i] ? o : 0) * taps * a.C;
  }

  auto load = [&](const KStep& k, int stage) {
    const int r = k.tap / a.KW;
    const int s = k.tap - r * a.KW;
    const int cend = a.goff[k.g + 1];
    const int c = k.c0 + chunk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 64 * i;
      bool ok = a_ok[i];
      const int8_t* src = a_base[i] + c;
      if (kConv) {
        const int ih = a_ih[i] + r;
        const int iw = a_iw[i] + s;
        ok = ok && (unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W;
        src = a_base[i] + ((long long)ih * a.W + iw) * a.C + c;
      }
      int8_t* dstA = &sA[stage][row * kRowBytes + chunk];
      const int8_t* srcb = b_base[i] + (long long)k.tap * a.C + c;
      int8_t* dstB = &sB[stage][row * kRowBytes + chunk];
      if (kVec) {  // C and the group offsets are multiples of 16
        const bool a_in = ok && c < cend;
        const bool b_in = b_ok[i] && c < cend;
        cp_async16(dstA, a_in ? src : a.x, a_in ? 16 : 0);
        cp_async16(dstB, b_in ? srcb : a.w, b_in ? 16 : 0);
      } else {
        uint32_t va[4] = {0, 0, 0, 0}, vb[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (c + j < cend) {
            if (ok) va[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
            if (b_ok[i]) vb[j >> 2] |= (uint32_t)(uint8_t)srcb[j] << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(dstA) = make_uint4(va[0], va[1], va[2], va[3]);
        *reinterpret_cast<uint4*>(dstB) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
      }
    }
  };

  int total = 0;
  for (int g = 0; g < a.groups; ++g)
    total += taps * ((a.goff[g + 1] - a.goff[g] + kBK - 1) / kBK);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 2) * 64;  // warp's rows in the tile
  const int wn = (warp & 3) * 32;   // warp's columns
  const int gq = lane >> 2;         // mma "groupID"
  const int tq = lane & 3;          // mma "threadID_in_group"

  int acc[4][4][4];
  float facc[kSplit ? 4 : 1][kSplit ? 4 : 1][kSplit ? 4 : 1];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  KStep ld = {0, 0, a.goff[0]};
  KStep cs = ld;  // the step being computed (split convs)
  load(ld, 0);
  cp_async_commit();
  advance(ld, a, taps);

  for (int kt = 0; kt < total; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < total) {
      load(ld, stage ^ 1);
      advance(ld, a, taps);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = &sA[stage][(wm + mt * 16 + gq) * kRowBytes + ks + tq * 4];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = &sB[stage][(wn + nt * 8 + gq) * kRowBytes + ks + tq * 4];
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }

    if constexpr (kSplit) {
      const int g = cs.g;
      advance(cs, a, taps);
      if (cs.g != g) {  // the group's last slice: fold its int32 sum into fp32
        // The order of ops/kernels.py: _split_sum: group 0's sum waits
        // unscaled, group 1 adds fma(sum0, s0, sum1 * s1), and each later
        // group adds fma(sum_g, s_g, running sum).
        const float s = a.sxg[g];
        const float s0 = a.sxg[0];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float sum = __int2float_rn(acc[mt][nt][e]);
              float& f = facc[mt][nt][e];
              f = g == 0   ? sum
                  : g == 1 ? __fmaf_rn(f, s0, __fmul_rn(sum, s))
                           : __fmaf_rn(sum, s, f);
              acc[mt][nt][e] = 0;
            }
      }
    }
    __syncthreads();
  }

  // Epilogue: c0, c1 at row gq, columns 2*tq + {0, 1}; c2, c3 at row gq + 8.
  const float sx = (a.mode >= kEpiF32 && a.sx != nullptr) ? *a.sx : 1.0f;
  const float os_scalar = (a.mode == kEpiI8 && !a.out_scale_vec) ? *a.out_scale : 1.0f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + wn + nt * 8 + tq * 2 + j;
      if (o >= a.O) continue;
      float deq = 0.0f, bias = 0.0f, os = 1.0f;
      if (a.mode >= kEpiF32) {
        deq = a.sx != nullptr ? __fmul_rn(sx, a.ws[o]) : a.ws[o];
        bias = a.bias[o];
        if (a.mode == kEpiI8) os = a.out_scale_vec ? a.out_scale[o] : os_scalar;
      }
      const bool homogeneous = a.act == kLeaky || a.act == kRelu || a.act == kLinear;
      const float deq_os = __fdiv_rn(deq, os);
      const float bias_os = __fdiv_rn(bias, os);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + mt * 16 + gq + 8 * h;
          if (m >= a.M) continue;
          const long long idx = (long long)m * a.O + o;
          const int e = 2 * h + j;
          const int iacc = acc[mt][nt][e];
          float v;
          if constexpr (kSplit) {
            v = a.groups == 1 ? __fmul_rn(facc[mt][nt][e], a.sxg[0]) : facc[mt][nt][e];
          } else {
            v = __int2float_rn(iacc);
          }
          switch (a.mode) {
            case kEpiAcc:
              static_cast<int*>(a.out)[idx] = iacc;
              break;
            case kEpiFixed: {
              const int scaled = (iacc >> a.pre) * a.mul;
              const int y = iacc > 0 ? scaled >> a.sh : scaled >> (a.sh + 3);
              static_cast<int8_t*>(a.out)[idx] = (int8_t)min(max(y, -127), 127);
              break;
            }
            case kEpiF32:
              static_cast<float*>(a.out)[idx] = activate(__fmaf_rn(v, deq, bias), a.act);
              break;
            default: {  // kEpiI8
              float y;
              if (homogeneous) {  // divide first, activate after
                y = activate(__fmaf_rn(v, deq_os, bias_os), a.act);
              } else {            // activate at the true scale, then divide
                y = __fdiv_rn(activate(__fmaf_rn(v, deq, bias), a.act), os);
              }
              static_cast<int8_t*>(a.out)[idx] = requant(y);
            }
          }
        }
      }
    }
  }
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
template <bool kConv>
int launch_igemm(const IgemmArgs* args, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const IgemmArgs a = *args;
  if (a.groups < 1 || a.groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  if (a.M == 0 || a.O == 0) return 0;
  const dim3 grid((unsigned)((a.M + kBM - 1) / kBM), (unsigned)((a.O + kBN - 1) / kBN));
  cudaStream_t s = (cudaStream_t)stream;
  const bool split = a.sxg != nullptr;
  if (split && vec)
    igemm_kernel<kConv, true, true><<<grid, kThreads, 0, s>>>(a);
  else if (split)
    igemm_kernel<kConv, true, false><<<grid, kThreads, 0, s>>>(a);
  else if (vec)
    igemm_kernel<kConv, false, true><<<grid, kThreads, 0, s>>>(a);
  else
    igemm_kernel<kConv, false, false><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
