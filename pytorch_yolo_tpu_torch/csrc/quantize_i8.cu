// K6: the int8 input quantizer of the int8 serving path, and the dynamic
// scale (its max|x| and the scale itself).
//
// Replaces no Pallas kernel: on the TPU XLA fused these into every int8
// conv of pytorch_yolo_tpu/ops/quant.py: quantized_conv.  There the input
// is widened to fp32, divided by its scale and rounded,
// `clip(round(x / sx), -127, 127)` cast to int8 (:593-596; each branch of a
// split concat at its own scale, :573-585, where XLA reads each slice of the
// concat straight from its source, so no concatenated copy exists); a
// dynamic scale is `max|x| / 127 + eps` (:595), which XLA computes as one
// fma(max, RN(1/127), eps).
//
// yolo_quantize_i8: up to kMaxBranches branches -> one NHWC int8 output;
// branch g fills channels [out_offset, out_offset + channels) of every row,
// so a route's sources are quantized into their concatenation without the
// concatenated copy.  A branch is bf16 or fp32, dense or a channel slice of
// a wider tensor (row_stride > channels), at a device scalar scale or a
// (channels,) vector.  The bits are the plain version's (ops/kernels.py:
// quantize_i8_ref): bf16 is widened exactly in registers, the quotient is
// x / s rounded to nearest, then rounded half to even and clamped to +-127
// (a NaN quotient gives 0, as torch's and XLA's casts do).  NVCC_FLAGS
// carry no --use_fast_math.
//
// The quotient at a scalar scale.  r = RN(1/s) once a block and branch;
// then q0 = RN(x r) and two residual corrections q <- RN(q + r RN(x - s q)),
// each residual one FMA.  q0 is within 1.5 ulps of x/s; the first
// correction makes it faithful, and from a faithful q the residual is exact
// and the second correction gives RN(x / s) itself (Markstein's theorem:
// r within half an ulp of 1/s, no underflow or overflow).  So the int8 is
// __fdiv_rn's, for five FMA-pipe ops an element and no reciprocal or range
// check an element.  It holds for 2^-96 <= s <= 2^96 (other scales divide
// with __fdiv_rn) and |q0| < 2^100: a vector with a quotient beyond (an
// inf, a NaN, a huge value) is quantized again with __fdiv_rn.  The
// rounding is then one add of 1.5 * 2^23 to the clamped quotient (round
// half to even; the int8 is the sum's low byte) and the bytes are packed
// with byte permutes: no float-to-int conversion, whose pipe runs at a
// quarter of the FMA rate.  chip_smoke.py phase 7 holds it against the
// plain version over every bf16 and every fp32 bit pattern at several
// scales.  A per-channel scale divides each element with __fdiv_rn.
//
// yolo_absmax: max|x| over the same branches, into 3 floats (max, scale,
// ticket) that the entry zeroes on the stream first.  |x| of a float orders
// as its bit pattern with the sign cleared, so blocks reduce patterns and
// merge them with one atomicMax a block (exact: torch's `x.abs().amax()` bit
// for bit; a NaN input gives NaN); the last block to finish (a ticket) reads
// the max back and writes the scale `fma(max, RN(1/127), RN(1e-12))`, the
// bits of ops/quant.py: scale_of_amax: a dynamic conv's scale is one launch.
//
// What bounds both on an H100: HBM, and for bf16 nearly the issue rate
// too.  The quantizer reads 4 (fp32) or 2 (bf16) bytes an element and
// writes 1; at yolov3's largest int8sb input, (128, 52, 52, 256) fp32,
// 443 MB, 0.132 ms at 3.35 TB/s.  At that rate an SM must quantize 3.6
// fp32 or 7.2 bf16 elements a cycle, of the 128 instructions it issues: a
// bf16 element can spend about 15.  The design:
//   * 16-byte vectors: lane i of a warp takes the vector at 16 i bytes of
//     each 512-byte run, so a warp's loads and its 4- (fp32) or 8-byte
//     (bf16) int8 stores are contiguous (a branch's rows map to rows of the
//     output);
//   * a persistent grid of one wave (the occupancy the registers allow;
//     ptxas -v in csrc/_build/build.log) walks warp tiles of kLaneVecs
//     vectors a lane round-robin, the next tile's loads held in registers
//     while this one is quantized (a register double buffer);
//   * a launch of one flat branch at a scalar scale (every int8 conv input
//     but a concat's) runs a copy of the loop specialised for its dtype,
//     with no per-vector lookup of branch, layout or dtype;
//   * an element the vectors do not cover (a ragged tail, a branch off the
//     16-byte grid or whose rows do not hold whole vectors) goes one a
//     thread after the tiles.
// yolo_absmax runs the same loop with a max in place of the quantizer.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_guard.cuh"

namespace {

constexpr int kMaxBranches = 8;  // ops/kernels.py: MAX_QUANT_BRANCHES
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneVecs = 2;               // 16-byte vectors a lane in a warp tile
constexpr int kWarpTile = 32 * kLaneVecs;  // vectors a warp tile: 1 KB
constexpr float kInv127 = 0x1.020408p-7f;  // RN(1/127)
constexpr float kEps = 0x1.197998p-40f;    // RN(1e-12): ops/quant.py _QEPS
constexpr float kExactLo = 0x1p-96f, kExactHi = 0x1p96f, kSaturated = 0x1p100f;
constexpr float kRound = 0x1.8p23f;  // q + kRound: rint(q) in the low bits, for |q| < 2^22

enum Mode { kFlat = 0, kRows = 1, kElems = 2 };  // how a branch's elements are reached

// One branch; ops/kernels.py: _QuantBranch, field for field.  `vecs`,
// `first_tile` and `mode` are set by the launcher.
struct QuantBranch {
  const void* x;         // element (row r, channel c) at x + r * row_stride + c
  const float* scale;    // a scalar, or `channels` floats when scale_vec
  long long rows;
  long long vecs;        // whole 16-byte vectors the tiles cover
  long long first_tile;  // tiles are numbered across branches
  int channels, row_stride, out_offset, elem_bytes, scale_vec, mode;
};

// ops/kernels.py: _QuantArgs.  `tiles` is set by the launcher.
struct QuantArgs {
  QuantBranch b[kMaxBranches];
  void* out;  // int8 (rows, out_channels); yolo_absmax: 3 floats
  long long tiles;
  int branches, out_channels;
};

// A branch's scalar scale, its reciprocal and whether the reciprocal may
// stand in for the division; staged once a block.
struct Scale {
  float s, r;
  int exact;
};

__device__ __forceinline__ float bf16_to_float(uint32_t bits) { return __uint_as_float(bits << 16); }

// RN(x / s) for one element (see the header); r = RN(1/s).
__device__ __forceinline__ float quotient(float x, const Scale& sc) {
  if (!sc.exact) return __fdiv_rn(x, sc.s);
  const float q0 = __fmul_rn(x, sc.r);
  const float q1 = __fmaf_rn(__fmaf_rn(-sc.s, q0, x), sc.r, q0);
  const float q2 = __fmaf_rn(__fmaf_rn(-sc.s, q1, x), sc.r, q1);
  return fabsf(q0) < kSaturated ? q2 : q0;
}

// clamp(rint(q), -127, 127) as an int8 in the low byte; NaN -> 0.
__device__ __forceinline__ uint32_t to_i8(float q) {
  const int i = q == q ? min(max(__float2int_rn(q), -127), 127) : 0;
  return (uint32_t)i & 0xFFu;
}

// Four elements at a scalar scale by the reciprocal -> four int8 in a
// word; false where a quotient left its range (the caller divides then).
__device__ __forceinline__ bool quantize4_fast(const float* f, const Scale& sc, uint32_t& word) {
  bool ok = true;
  uint32_t t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q0 = __fmul_rn(f[i], sc.r);
    ok &= fabsf(q0) < kSaturated;
    const float q1 = __fmaf_rn(__fmaf_rn(-sc.s, q0, f[i]), sc.r, q0);
    const float q2 = __fmaf_rn(__fmaf_rn(-sc.s, q1, f[i]), sc.r, q1);
    t[i] = __float_as_uint(__fadd_rn(fminf(fmaxf(q2, -127.0f), 127.0f), kRound));
  }
  word = __byte_perm(__byte_perm(t[0], t[1], 0x0040), __byte_perm(t[2], t[3], 0x0040), 0x5410);
  return ok;
}

// Four elements by IEEE division, each at its own scale.
__device__ __forceinline__ uint32_t quantize4_divide(const float* f, const float* s) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) word |= to_i8(__fdiv_rn(f[i], s[i])) << (8 * i);
  return word;
}

__device__ __forceinline__ void stage_scales(const QuantArgs& a, Scale* scales) {
  const int g = threadIdx.x;
  if (g < a.branches) {
    const QuantBranch& b = a.b[g];
    Scale sc{1.0f, 1.0f, 0};
    if (!b.scale_vec) {
      sc.s = __ldg(b.scale);
      sc.r = __frcp_rn(sc.s);
      sc.exact = sc.s >= kExactLo && sc.s <= kExactHi;
    }
    scales[g] = sc;
  }
}

// A launch's kind: kFlatF32 or kFlatBf16 for one flat branch at a scalar
// scale (every int8 conv input but a concat's), where the per-vector
// dispatch below folds away at compile time; kAny otherwise.
enum Kind { kAny = 0, kFlatBf16 = 2, kFlatF32 = 4 };

__device__ __forceinline__ int kind_of(const QuantArgs& a) {
  const QuantBranch& b = a.b[0];
  return a.branches == 1 && b.mode == kFlat && !b.scale_vec ? b.elem_bytes : kAny;
}

template <int kKind>
__device__ __forceinline__ int branch_of(const QuantArgs& a, long long tile) {
  if constexpr (kKind != kAny) return 0;
  int g = 0;
  while (g + 1 < a.branches && tile >= a.b[g + 1].first_tile) ++g;
  return g;
}

// Element e of branch b: its offset in b.x (elements) and in the output
// (bytes), and its channel.  kRows and a per-channel kFlat branch hold
// fewer than 2^32 elements (the launcher checks), so the row is a 32-bit
// division.
struct Where {
  long long in, out;
  int col;
};

__device__ __forceinline__ Where locate(const QuantBranch& b, long long e, int out_channels) {
  if (b.mode == kFlat && !b.scale_vec) return {e, e, 0};
  const uint32_t c = (uint32_t)b.channels;
  const uint32_t row = (uint32_t)e / c;
  const int col = (int)((uint32_t)e - row * c);
  if (b.mode == kFlat) return {e, e, col};
  return {(long long)row * b.row_stride + col, (long long)row * out_channels + b.out_offset + col,
          col};
}

__device__ __forceinline__ const uint4* vec_at(const QuantBranch& b, long long v, int out_channels) {
  const long long e = v * (16 / b.elem_bytes);
  const long long in = b.row_stride == b.channels ? e : locate(b, e, out_channels).in;
  return reinterpret_cast<const uint4*>(static_cast<const char*>(b.x) + in * b.elem_bytes);
}

// Quantize vector v of branch b (K = 4 fp32 or 8 bf16 elements) into the
// output: one 4- or 8-byte store.  kSimple: a flat branch at a scalar scale.
template <int K, bool kSimple>
__device__ __forceinline__ void quantize_vec(const QuantBranch& b, const Scale& sc, const uint4 u,
                                             long long v, int out_channels, int8_t* out) {
  const Where at = kSimple ? Where{v * K, v * K, 0} : locate(b, v * K, out_channels);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float f[K];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (K == 4) {
      f[j] = __uint_as_float(w[j]);
    } else {
      f[2 * j] = bf16_to_float(w[j] & 0xFFFFu);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
  uint32_t q[K / 4];
  if (!kSimple && b.scale_vec) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(b.scale + at.col) + j);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      q[j] = quantize4_divide(f + 4 * j, s);
    }
  } else {
    bool ok = sc.exact;
    if (ok) {
#pragma unroll
      for (int j = 0; j < K / 4; ++j) ok &= quantize4_fast(f + 4 * j, sc, q[j]);
    }
    if (!ok) {
      const float s[4] = {sc.s, sc.s, sc.s, sc.s};
#pragma unroll
      for (int j = 0; j < K / 4; ++j) q[j] = quantize4_divide(f + 4 * j, s);
    }
  }
  if constexpr (K == 4)
    *reinterpret_cast<uint32_t*>(out + at.out) = q[0];
  else
    *reinterpret_cast<uint2*>(out + at.out) = make_uint2(q[0], q[1]);
}

__device__ __forceinline__ uint32_t vec_absmax(const uint4 u, bool bf16, uint32_t m) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (bf16)
      m = max(m, max((w[j] & 0x7FFFu) << 16, w[j] & 0x7FFF0000u));
    else
      m = max(m, w[j] & 0x7FFFFFFFu);
  }
  return m;
}

// One vector's work: quantize it into the output, or fold |x| into m.
template <bool kReduce, int kKind>
__device__ __forceinline__ void vec_work(const QuantArgs& a, const QuantBranch& b, const Scale& sc,
                                         const uint4 u, long long v, uint32_t& m) {
  const bool bf16 = kKind != kAny ? kKind == kFlatBf16 : b.elem_bytes == 2;
  if constexpr (kReduce) {
    m = vec_absmax(u, bf16, m);
  } else {
    int8_t* out = static_cast<int8_t*>(a.out);
    if (bf16)
      quantize_vec<8, kKind != kAny>(b, sc, u, v, a.out_channels, out);
    else
      quantize_vec<4, kKind != kAny>(b, sc, u, v, a.out_channels, out);
  }
}

__device__ __forceinline__ float load_one(const QuantBranch& b, long long in) {
  if (b.elem_bytes == 2) return bf16_to_float(static_cast<const uint16_t*>(b.x)[in]);
  return static_cast<const float*>(b.x)[in];
}

// After the tiles: every element they do not cover (a branch's ragged tail,
// or a whole kElems branch), one a thread over the grid; then, for
// absmax, the block's max merged into the output, and the last block
// writes the scale.
template <bool kReduce>
__device__ __forceinline__ void finish(const QuantArgs& a, const Scale* scales, uint32_t m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int g = 0; g < a.branches; ++g) {
    const QuantBranch& b = a.b[g];
    const long long n = b.rows * b.channels;
    for (long long e = b.vecs * (16 / b.elem_bytes) + tid; e < n; e += stride) {
      const long long row = e / b.channels, col = e - row * b.channels;
      const float x = load_one(b, row * b.row_stride + col);
      if constexpr (kReduce) {
        m = max(m, __float_as_uint(x) & 0x7FFFFFFFu);
      } else {
        const float q = b.scale_vec ? __fdiv_rn(x, __ldg(b.scale + col)) : quotient(x, scales[g]);
        static_cast<int8_t*>(a.out)[row * a.out_channels + b.out_offset + col] = (int8_t)to_i8(q);
      }
    }
  }
  if constexpr (kReduce) {
    __shared__ uint32_t warp_max[kWarps];
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = threadIdx.x < kWarps ? warp_max[threadIdx.x] : 0u;
      m = __reduce_max_sync(0xFFFFFFFFu, m);
      if (threadIdx.x == 0) {
        unsigned int* o = static_cast<unsigned int*>(a.out);
        atomicMax(o, m);
        __threadfence();
        if (atomicAdd(o + 2, 1u) == gridDim.x - 1) {  // the last block: every max is in
          const float mx = __uint_as_float(atomicMax(o, 0u));
          static_cast<float*>(a.out)[1] = __fmaf_rn(mx, kInv127, kEps);
        }
      }
    }
  }
}

// --- warp tiles round-robin, the next one's loads in registers ------------

template <int kKind>
__device__ __forceinline__ void load_tile(const QuantArgs& a, long long t, int lane,
                                          uint4 (&d)[kLaneVecs]) {
  const QuantBranch& b = a.b[branch_of<kKind>(a, t)];
  const long long v0 = (t - b.first_tile) * kWarpTile + lane;
#pragma unroll
  for (int h = 0; h < kLaneVecs; ++h) {
    const long long v = v0 + 32 * h;
    if (v < b.vecs)
      d[h] = __ldg(kKind != kAny ? static_cast<const uint4*>(b.x) + v
                                 : vec_at(b, v, a.out_channels));
  }
}

template <bool kReduce, int kKind>
__device__ __forceinline__ void tile_loop(const QuantArgs& a, const Scale* scales, uint32_t& m) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  uint4 cur[kLaneVecs], next[kLaneVecs];
  if (t < a.tiles) load_tile<kKind>(a, t, lane, cur);
  for (; t < a.tiles; t += warps) {
    if (t + warps < a.tiles) load_tile<kKind>(a, t + warps, lane, next);  // in flight meanwhile
    const int g = branch_of<kKind>(a, t);
    const QuantBranch& b = a.b[g];
    const long long v0 = (t - b.first_tile) * kWarpTile + lane;
#pragma unroll
    for (int h = 0; h < kLaneVecs; ++h)
      if (v0 + 32 * h < b.vecs) vec_work<kReduce, kKind>(a, b, scales[g], cur[h], v0 + 32 * h, m);
#pragma unroll
    for (int h = 0; h < kLaneVecs; ++h) cur[h] = next[h];
  }
}

template <bool kReduce>
__global__ void __launch_bounds__(kThreads) k6_tile_kernel(const __grid_constant__ QuantArgs a) {
  __shared__ Scale scales[kMaxBranches];
  if constexpr (!kReduce) stage_scales(a, scales);
  __syncthreads();
  uint32_t m = 0;
  const int kind = kind_of(a);
  if (kind == kFlatF32)
    tile_loop<kReduce, kFlatF32>(a, scales, m);
  else if (kind == kFlatBf16)
    tile_loop<kReduce, kFlatBf16>(a, scales, m);
  else
    tile_loop<kReduce, kAny>(a, scales, m);
  finish<kReduce>(a, scales, m);
}

// --- launch -----------------------------------------------------------------

// Fill in each branch's mode, vectors and first tile; `reduce` (absmax)
// ignores the output layout.  Sets *loose to the elements left to the
// one-a-thread pass.
int prepare(QuantArgs& a, bool reduce, long long* loose) {
  if (a.branches < 1 || a.branches > kMaxBranches || a.out_channels < 1)
    return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  *loose = 0;
  for (int g = 0; g < a.branches; ++g) {
    QuantBranch& b = a.b[g];
    if ((b.elem_bytes != 2 && b.elem_bytes != 4) || b.channels < 1 || b.row_stride < b.channels ||
        b.rows < 0 || (!reduce && (b.rows != a.b[0].rows || b.scale == nullptr)))
      return (int)cudaErrorInvalidValue;
    const int k = 16 / b.elem_bytes;
    const long long n = b.rows * b.channels;
    const bool small = n < (1LL << 32);
    const bool aligned = reinterpret_cast<uintptr_t>(b.x) % 16 == 0 &&
                         (!b.scale_vec || reinterpret_cast<uintptr_t>(b.scale) % 16 == 0);
    const bool whole = b.channels % k == 0 && b.row_stride % k == 0;
    const bool flat = b.row_stride == b.channels &&
                      (reduce || (a.branches == 1 && b.channels == a.out_channels &&
                                  b.out_offset == 0 && (!b.scale_vec || (whole && small))));
    const bool rows = whole && small &&
                      (reduce || (b.out_offset % k == 0 && a.out_channels % k == 0));
    b.mode = !aligned ? kElems : flat ? kFlat : rows ? kRows : kElems;
    b.vecs = b.mode == kElems ? 0 : n / k;
    b.first_tile = tiles;
    tiles += (b.vecs + kWarpTile - 1) / kWarpTile;
    *loose += n - b.vecs * k;
  }
  a.tiles = tiles;
  return 0;
}

constexpr int kDevices = 64;

// Blocks of one wave of the quantizer (reduce 0) or absmax (reduce 1) on
// `device`: the occupancy its registers allow, times the SMs; one table a
// device, under a lock.
template <typename Kernel>
int wave(Kernel kernel, int reduce, int device, int* blocks) {
  static std::mutex mu;
  static int table[kDevices][2] = {};
  if (device < 0 || device >= kDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  int& most = table[device][reduce];
  if (!most) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    most = max(1, per_sm) * sms;
  }
  *blocks = most;
  return 0;
}

// Launch K6's quantizer (kReduce false) or absmax: one wave at most, at
// least one block.
template <bool kReduce>
int launch(QuantArgs a, int device, cudaStream_t stream) {
  long long loose = 0;
  int err = prepare(a, kReduce, &loose);
  if (err != 0) return err;
  int most = 0;
  err = wave(k6_tile_kernel<kReduce>, (int)kReduce, device, &most);
  if (err != 0) return err;
  const long long want = max((a.tiles + kWarps - 1) / kWarps, (loose + kThreads - 1) / kThreads);
  const int blocks = (int)max(1LL, min(want, (long long)most));
  k6_tile_kernel<kReduce><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Quantize the branches of `args` (a QuantArgs) into its int8 output (16-
// byte aligned), on `stream` of `device`.  Returns a CUDA error code (0 =
// ok).
extern "C" int yolo_quantize_i8(const void* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const QuantArgs& a = *static_cast<const QuantArgs*>(args);
  if (reinterpret_cast<uintptr_t>(a.out) % 16 != 0) return (int)cudaErrorInvalidValue;
  return launch<false>(a, device, (cudaStream_t)stream);
}

// max|x| over the branches of `args` into its 3-float output (max, scale,
// ticket), zeroed first on `stream`.
extern "C" int yolo_absmax(const void* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const QuantArgs& a = *static_cast<const QuantArgs*>(args);
  const cudaError_t e = cudaMemsetAsync(a.out, 0, 3 * sizeof(float), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return launch<true>(a, device, (cudaStream_t)stream);
}
