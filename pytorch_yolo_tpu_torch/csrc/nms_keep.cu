// Batched greedy-NMS keep mask by parallel fixpoint, one block per image.
//
// Replaces the Pallas TPU kernel pytorch_yolo_tpu/ops/pallas_kernels.py:
// nms_keep_pallas (body _nms_kernel).  Inputs: K score-sorted corner boxes
// per image (N, K, 4) fp32, a validity mask (N, K) bool, optional class ids
// (N, K) fp32.  Output: (N, K) bool keep mask, the same keep-set as
// sequential greedy NMS (pytorch_yolo_tpu/ops/nms.py: greedy_suppress).
//
// Rule: candidate i is KEPT iff every higher-ranked candidate j that
// overlaps it (IoU > thr, and the same class when class-wise) is KILLED;
// it is KILLED iff some such j is KEPT.  Invalid rows start out killed.
// Each round applies the rule to every undecided candidate at once from
// the previous round's sets (Jacobi), which decides at least the highest
// ranked undecided candidate, so the loop ends after at most K rounds and
// in practice after the depth of the suppression chain.
//
// What bounds it on an H100: latency — rounds times block barriers.  One
// image's working set (K = 300: 4.8 KB of boxes, a 12 KB overlap bitmask)
// fits in one SM's shared memory, and device memory is touched once.
//
// Design: ceil(K/32)*32 threads, thread i owns candidate i.  The relation
// "j ranks above i and overlaps it" is built once as a bitmask pred[i] of
// ceil(K/32) words.  kept/killed are bitsets; a round is, per thread, an AND
// of its pred words with ~killed and with kept, then a warp ballot per word.
// The loop runs while __syncthreads_or(some candidate undecided).  The TPU
// kernel's triangle-mask input, 128-lane padding, bounded fori loop and
// SMEM done flag were Mosaic workarounds and have no counterpart here.
//
// The keep-set must equal the plain torch version's bit for bit, so an IoU
// on the threshold must decide the same way: the IoU is written with _rn
// intrinsics in the order of pytorch_yolo_tpu/ops/nms.py: iou_matrix (no
// FMA contraction), max/min/clamp propagate NaN as torch's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;  // torch.maximum: NaN wins
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;  // torch.minimum: NaN wins
}
__device__ __forceinline__ float clamp0(float a) {
  return a < 0.0f ? 0.0f : a;  // clamp(min=0) keeps NaN
}

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                const float* __restrict__ cls, uint8_t* __restrict__ keep,
                                int k, int words, float iou_thresh) {
  extern __shared__ uint32_t smem[];
  uint32_t* pred = smem;                 // [k][words]
  uint32_t* kept = pred + k * words;     // [words]
  uint32_t* killed = kept + words;       // [words]
  float* x1 = reinterpret_cast<float*>(killed + words);
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  float* cl = area + k;

  const int img = blockIdx.x;
  const int i = threadIdx.x;
  const bool in = i < k;
  const long long base = (long long)img * k;

  bool live = false;
  if (in) {
    const float4 b = reinterpret_cast<const float4*>(boxes + base * 4)[i];
    x1[i] = b.x;
    y1[i] = b.y;
    x2[i] = b.z;
    y2[i] = b.w;
    area[i] = __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
    cl[i] = cls ? cls[base + i] : 0.0f;
    live = valid[base + i] != 0;
  }
  const uint32_t dead = __ballot_sync(kFull, !live);  // invalid rows and padding lanes
  if ((i & 31) == 0) {
    kept[i >> 5] = 0u;
    killed[i >> 5] = dead;
  }
  __syncthreads();

  if (in) {
    const float xi1 = x1[i], yi1 = y1[i], xi2 = x2[i], yi2 = y2[i], ai = area[i], ci = cl[i];
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0u;
      const int j0 = w * 32;
      const int j1 = min(j0 + 32, i);  // only higher-ranked candidates j < i
      for (int j = j0; j < j1; ++j) {
        if (cls && !(fabsf(__fsub_rn(ci, cl[j])) < 0.5f)) continue;
        const float iw = clamp0(__fsub_rn(min_nan(x2[j], xi2), max_nan(x1[j], xi1)));
        const float ih = clamp0(__fsub_rn(min_nan(y2[j], yi2), max_nan(y1[j], yi1)));
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(area[j], ai), inter);
        const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
        if (iou > iou_thresh) bits |= 1u << (j - j0);
      }
      pred[i * words + w] = bits;
    }
  }

  bool undecided = live;
  while (__syncthreads_or(undecided)) {
    bool blocked = false, kill = false;
    if (undecided) {
      const uint32_t* pr = pred + i * words;
      for (int w = 0; w < words; ++w) {
        const uint32_t p = pr[w];
        blocked |= (p & ~killed[w]) != 0u;
        kill |= (p & kept[w]) != 0u;
      }
    }
    __syncthreads();  // every thread has read this round's sets
    const bool now_kept = undecided && !blocked;
    const bool now_killed = undecided && kill;  // kill implies blocked
    const uint32_t kb = __ballot_sync(kFull, now_kept);
    const uint32_t db = __ballot_sync(kFull, now_killed);
    if ((i & 31) == 0) {
      kept[i >> 5] |= kb;
      killed[i >> 5] |= db;
    }
    undecided = undecided && !now_kept && !now_killed;
  }
  if (in) keep[base + i] = (uint8_t)((kept[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// `cls` may be null (class-agnostic suppression).  Requires 1 <= k <= 1024.
extern "C" int yolo_nms_keep(const float* boxes, const uint8_t* valid, const float* cls,
                             uint8_t* keep, int n, int k, float iou_thresh, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int words = (k + 31) / 32;
  const size_t smem = ((size_t)k * words + 2 * words) * sizeof(uint32_t) + 6 * (size_t)k * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_kernel<<<n, words * 32, smem, (cudaStream_t)stream>>>(boxes, valid, cls, keep, k,
                                                                 words, iou_thresh);
  return (int)cudaGetLastError();
}
