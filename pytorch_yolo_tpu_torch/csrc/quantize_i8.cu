// K6: the int8 input quantizer of the int8 serving path, and the dynamic
// scale's max|x|.
//
// Replaces no Pallas kernel: on the TPU XLA fused these into every int8
// conv of pytorch_yolo_tpu/ops/quant.py: quantized_conv.  There the input
// is widened to fp32 (`x.astype(float32)`), divided by its scale and
// rounded, `clip(round(x / sx), -127, 127)` cast to int8 (:593-596, and
// each branch of a split concat at its own scale, :577-582); a dynamic
// scale is `max|x| / 127 + eps` (:595).  In PyTorch those are four passes
// over the activation (divide, round, clamp, cast) after an fp32 copy of a
// bf16 input, and `abs` written out in full before `amax`.
//
// yolo_quantize_i8: a contiguous NHWC bf16 or fp32 input -> int8, at a
// device scalar scale or a per-channel (C,) vector indexed by i % C (a
// split concat passes the vector of its branches' scales).  The bits are
// the plain version's (ops/kernels.py: quantize_i8_ref): bf16 is widened
// exactly in registers, the quotient is an IEEE division (__fdiv_rn, as
// torch and XLA:CPU divide; never a multiply by a reciprocal), rounding is
// rintf (half to even, as torch.round and jnp.round), then the clamp to
// +-127.  NVCC_FLAGS carry no --use_fast_math.
//
// yolo_absmax: max|x| of a bf16 or fp32 tensor into a 0-d fp32 on the
// device.  |x| of a float orders as its bit pattern with the sign cleared
// (as uint32), so each block reduces the patterns and one atomicMax a
// block merges them; the max is exact, so it equals torch's
// `x.abs().amax()` bit for bit (a NaN pattern sorts above +inf: a NaN
// input gives NaN, as torch does).
//
// What bounds both on an H100: HBM.  The quantizer reads 4 (fp32) or 2
// (bf16) bytes an element and writes 1; at yolov3's largest int8sb input,
// (128, 52, 52, 256) fp32, that is 443 MB, 0.132 ms at 3.35 TB/s.  The
// design: 16-byte loads and stores (16 elements a thread a turn: four
// fp32 or two bf16 vectors in, one int8 vector out), a grid-stride loop
// over whole vectors, a scalar tail for the last n % 16 elements, one
// launch a conv input.  absmax reads each element once with the same
// vectors.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;        // elements a thread a turn: one 16-byte int8 store
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// One element: clamp(rint(x / s), -127, 127) as int8 (low byte).
__device__ __forceinline__ uint32_t quantize_one(float x, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// The 16 values of vector v (elements 16 v .. 16 v + 15) as fp32.
template <bool kBf16>
__device__ __forceinline__ void load16(const void* x, long long v, float (&f)[kVec]) {
  if constexpr (kBf16) {
    const uint4* p = static_cast<const uint4*>(x) + 2 * v;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = __ldg(p + h);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[8 * h + 2 * j] = bf16_bits_to_float(w[j] & 0xFFFFu);
        f[8 * h + 2 * j + 1] = bf16_bits_to_float(w[j] >> 16);
      }
    }
  } else {
    const float4* p = static_cast<const float4*>(x) + 4 * v;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 u = __ldg(p + h);
      f[4 * h] = u.x;
      f[4 * h + 1] = u.y;
      f[4 * h + 2] = u.z;
      f[4 * h + 3] = u.w;
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ float load_one(const void* x, long long i) {
  if constexpr (kBf16) {
    return bf16_bits_to_float(static_cast<const uint16_t*>(x)[i]);
  } else {
    return static_cast<const float*>(x)[i];
  }
}

// `channels` = 0: one scale for every element; else scale[i % channels].
template <bool kBf16>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const void* __restrict__ x,
                                                            const float* __restrict__ scale,
                                                            int channels,
                                                            int8_t* __restrict__ out,
                                                            long long n) {
  const long long vecs = n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float s0 = channels == 0 ? __ldg(scale) : 0.0f;
  // the channel of this thread's vector and its advance a turn, in 32 bits
  int c0 = channels == 0 ? 0 : (int)((first * kVec) % channels);
  const int step = channels == 0 ? 0 : (int)((stride * kVec) % channels);
  for (long long v = first; v < vecs; v += stride) {
    float f[kVec];
    load16<kBf16>(x, v, f);
    uint32_t w[4] = {0, 0, 0, 0};
    if (channels == 0) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) w[j >> 2] |= quantize_one(f[j], s0) << (8 * (j & 3));
    } else {
      int c = c0;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        w[j >> 2] |= quantize_one(f[j], __ldg(scale + c)) << (8 * (j & 3));
        if (++c == channels) c = 0;
      }
      c0 += step;
      if (c0 >= channels) c0 -= channels;
    }
    reinterpret_cast<uint4*>(out)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // the last n % 16 elements, one a thread
  const long long i = vecs * kVec + first;
  if (i < n) {
    const float s = channels == 0 ? s0 : __ldg(scale + (int)(i % channels));
    out[i] = (int8_t)quantize_one(load_one<kBf16>(x, i), s);
  }
}

__device__ __forceinline__ uint32_t abs_bits(float f) { return __float_as_uint(f) & 0x7FFFFFFFu; }

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) absmax_kernel(const void* __restrict__ x,
                                                          long long n,
                                                          unsigned int* __restrict__ out) {
  __shared__ uint32_t warp_max[kThreads / 32];
  const long long vecs = n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint32_t m = 0;
  for (long long v = first; v < vecs; v += stride) {
    float f[kVec];
    load16<kBf16>(x, v, f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) m = max(m, abs_bits(f[j]));
  }
  const long long i = vecs * kVec + first;
  if (i < n) m = max(m, abs_bits(load_one<kBf16>(x, i)));
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if (threadIdx.x == 0) atomicMax(out, m);
  }
}

// Blocks for n elements: enough to cover the vectors, at most
// kBlocksPerSm a streaming multiprocessor (the loop strides over the rest).
int grid_for(long long n, int device, int* blocks) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n / kVec + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  *blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  return 0;
}

}  // namespace

// x: n contiguous elements, 16-byte aligned, fp32 (elem_bytes 4) or bf16
// (2); scale: a device fp32 scalar (channels 0) or a (channels,) vector;
// out: n int8, 16-byte aligned.  Launches on `stream` of `device`; returns
// a CUDA error code (0 = ok).
extern "C" int yolo_quantize_i8(const void* x, int elem_bytes, const float* scale, int channels,
                                void* out, long long n, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if ((elem_bytes != 2 && elem_bytes != 4) || channels < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int blocks = 0;
  const int err = grid_for(n, device, &blocks);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    quantize_kernel<true><<<blocks, kThreads, 0, s>>>(x, scale, channels,
                                                      static_cast<int8_t*>(out), n);
  else
    quantize_kernel<false><<<blocks, kThreads, 0, s>>>(x, scale, channels,
                                                       static_cast<int8_t*>(out), n);
  return (int)cudaGetLastError();
}

// max|x| of n contiguous elements (16-byte aligned, fp32 or bf16) into the
// device fp32 `out`, which is zeroed first on `stream`.
extern "C" int yolo_absmax(const void* x, int elem_bytes, long long n, void* out, int device,
                           void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  int blocks = 0;
  const int err = grid_for(n, device, &blocks);
  if (err != 0) return err;
  unsigned int* o = static_cast<unsigned int*>(out);
  if (elem_bytes == 2)
    absmax_kernel<true><<<blocks, kThreads, 0, s>>>(x, n, o);
  else
    absmax_kernel<false><<<blocks, kThreads, 0, s>>>(x, n, o);
  return (int)cudaGetLastError();
}
