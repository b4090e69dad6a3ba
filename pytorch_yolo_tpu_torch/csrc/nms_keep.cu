// K2: batched greedy-NMS keep mask, one block per image: the whole block
// builds the overlap bitmask in 32 x 32 tiles, then one warp scans it.
// Above K = 1024 (the bitmask would outgrow shared memory: K²/8 bytes an
// image) the same bitmask is built in global memory by many blocks an
// image and scanned by one block an image (the large-K mode, at the end).
//
// Replaces the Pallas TPU kernel pytorch_yolo_tpu/ops/pallas_kernels.py:
// nms_keep_pallas (body _nms_kernel).  Inputs: K score-sorted corner boxes
// per image (N, K, 4) fp32, a validity mask (N, K) bool, optional class ids
// (N, K) fp32.  Output: (N, K) bool keep mask, the keep-set of sequential
// greedy NMS (pytorch_yolo_tpu/ops/nms.py: greedy_suppress): candidate i is
// kept iff it is valid and no kept higher-ranked candidate j < i overlaps
// it (IoU > thr, and the same class when class-wise).
//
// What bounds it on an H100: the IoU build, ~20-30 issued instructions a
// pair (an IEEE division among them) over K(K-1)/2 pairs an image, with
// one image a SM at batch 128; device memory is touched once (K = 300:
// 4.8 KB of boxes in, 300 bytes out an image).  A launch with no valid
// candidate, which computes no IoU, takes ~5 us at 128 x 300 on an H100
// SXM at 700 W (PERF.md).
//
// Design:
//   * the relation "j < i and j overlaps i" is a bitmask, pred[w][i] = the
//     bits of j in [32w, 32w+32), stored word-major so that a warp reading
//     one word of 32 consecutive candidates hits 32 banks;
//   * the build: every warp of the block takes 32 x 32 tiles (bi >= bj) of
//     the lower triangle in turn (55 tiles for K = 300).  Lane = column j;
//     the warp walks the tile's valid rows i, each lane computes IoU(j, i),
//     and one __ballot_sync turns the 32 answers into pred[bj][i].  A column
//     that is not valid gets NaN corners, so its IoU is NaN and never over
//     the threshold: invalid candidates start out killed and never block.
//     A row that no lane's class matches, or that no lane's box intersects,
//     is skipped by the whole warp after a vote, division and all: most
//     pairs of a frame are of other classes or far apart;
//   * the scan: one warp walks the words in rank order, no block barrier.
//     For word b, lane = candidate i = 32b + lane: it is killed if a kept
//     candidate of an earlier (final) word overlaps it, pred[w][i] &
//     kept[w]; then the candidates of the word are decided by rounds of
//     ballots inside the warp: a round keeps every undecided candidate whose
//     in-word overlappers are all killed and kills every undecided one that
//     a kept candidate overlaps.  The lowest undecided candidate is decided
//     in every round, so a word takes at most 32 rounds (a chain where each
//     box overlaps only its successor takes 16), and most take one or two.
//     A fixpoint over the whole block would need two block barriers a round
//     and as many rounds as the longest suppression chain, K at worst.
// The keep-set must equal the plain torch version's bit for bit, so an IoU
// on the threshold must decide the same way: the IoU is written with _rn
// intrinsics in the order of pytorch_yolo_tpu/ops/nms.py: iou_matrix (no
// FMA contraction, an IEEE division, no reciprocal), max/min propagate NaN
// as torch's do (max.NaN / min.NaN; the sign of a zero width cannot change
// an answer, since a zero intersection is never over a threshold that a
// zero would not also fail).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;  // ops/kernels.py: MAX_NMS_K_SHARED; above it, global memory

__device__ __forceinline__ float max_nan(float a, float b) {  // torch.maximum: NaN wins
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {  // torch.minimum: NaN wins
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float clamp0(float a) {  // clamp(min=0) keeps NaN
  return max_nan(a, 0.0f);
}

template <bool kClassWise>
__global__ void __launch_bounds__(1024)
    nms_keep_scan_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                         const float* __restrict__ cls, uint8_t* __restrict__ keep, int k,
                         int words, float iou_thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = words * 32;
  float4* box = reinterpret_cast<float4*>(smem);        // [kpad] x1, y1, x2, y2
  float2* ac = reinterpret_cast<float2*>(box + kpad);   // [kpad] area, class id
  uint32_t* live = reinterpret_cast<uint32_t*>(ac + kpad);  // [words] valid bits
  uint32_t* pred = live + words;                        // [words][kpad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long base = (long long)blockIdx.x * k;

  for (int i = tid; i < kpad; i += blockDim.x) {  // a warp's lanes share the trip count
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float c = 0.0f;
    bool on = false;
    if (i < k) {
      b = reinterpret_cast<const float4*>(boxes)[base + i];
      if (kClassWise) c = cls[base + i];
      on = valid[base + i] != 0;
    }
    box[i] = b;
    ac[i] = make_float2(__fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y))), c);
    const uint32_t bits = __ballot_sync(kFull, on);
    if (lane == 0) live[i >> 5] = bits;
  }
  __syncthreads();

  // The build: tile t of the lower triangle is (bi, bj), t = bi(bi+1)/2 + bj.
  const float nan = __int_as_float(0x7fffffff);
  const bool thresh_nonneg = iou_thresh >= 0.0f;
  const int tiles = words * (words + 1) / 2;
  for (int t = warp; t < tiles; t += nwarps) {
    int bi = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
    while (bi * (bi + 1) / 2 > t) --bi;
    const int bj = t - bi * (bi + 1) / 2;
    const int j = bj * 32 + lane;
    const bool jlive = (live[bj] >> lane) & 1u;
    const float4 cb = jlive ? box[j] : make_float4(nan, nan, nan, nan);
    const float2 cj = ac[j];
    uint32_t mine = 0u;  // lane r: pred[bj][32 bi + r]
    for (uint32_t rows = live[bi]; rows; rows &= rows - 1u) {
      const int r = __ffs(rows) - 1;
      const int i = bi * 32 + r;
      const float4 rb = box[i];
      const float2 ri = ac[i];
      // Exact shortcuts, taken by the whole warp or not at all: a row that
      // no lane's class matches, or (for a threshold >= 0, the only kind an
      // IoU can pass with no intersection) that no lane's box intersects,
      // sets no bit, so it skips the rest of the IoU and its division.
      const bool same = !kClassWise || fabsf(__fsub_rn(ri.y, cj.y)) < 0.5f;
      if (kClassWise && !__any_sync(kFull, same)) continue;
      const float iw = clamp0(__fsub_rn(min_nan(cb.z, rb.z), max_nan(cb.x, rb.x)));
      const float ih = clamp0(__fsub_rn(min_nan(cb.w, rb.w), max_nan(cb.y, rb.y)));
      const float inter = __fmul_rn(iw, ih);
      if (thresh_nonneg && !__any_sync(kFull, same && inter > 0.0f)) continue;
      const float uni = __fsub_rn(__fadd_rn(cj.x, ri.x), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      uint32_t word = __ballot_sync(kFull, same && iou > iou_thresh);
      if (bi == bj) word &= (1u << r) - 1u;  // the diagonal tile: only j < i
      if (lane == r) mine = word;
    }
    pred[bj * kpad + bi * 32 + lane] = mine;
  }
  __syncthreads();
  if (warp != 0) return;

  // The scan: lane w keeps the final keep bits of word w once it is done.
  uint32_t kept_w = 0u;
  for (int b = 0; b < words; ++b) {
    const int i = b * 32 + lane;
    uint32_t ext = 0u;
    for (int w = 0; w < b; ++w) ext |= pred[w * kpad + i] & __shfl_sync(kFull, kept_w, w);
    const uint32_t intra = pred[b * kpad + i];
    uint32_t undecided = __ballot_sync(kFull, ext == 0u) & live[b];
    uint32_t killed = ~undecided, kept = 0u;
    while (undecided) {
      const bool mine = (undecided >> lane) & 1u;
      const uint32_t now_kept = __ballot_sync(kFull, mine && (intra & ~killed) == 0u);
      const uint32_t now_killed = __ballot_sync(kFull, mine && (intra & (kept | now_kept)) != 0u);
      kept |= now_kept;
      killed |= now_killed;
      undecided &= ~(now_kept | now_killed);
    }
    if (lane == b) kept_w = kept;
  }
  for (int i0 = 0; i0 < k; i0 += 32) {
    const uint32_t w = __shfl_sync(kFull, kept_w, i0 >> 5);
    if (i0 + lane < k) keep[base + i0 + lane] = (uint8_t)((w >> lane) & 1u);
  }
}

// The large-K mode (1024 < K): the same word-major bitmask, built in global
// memory.  Any number of blocks per image take the lower-triangle tiles in
// turn, reading the boxes from global memory (each pair's IoU is the one
// the shared-memory kernel computes, operation for operation); the
// candidates' areas are recomputed where they are needed, with the same
// operations, so they are the same bits.
template <bool kClassWise>
__global__ void __launch_bounds__(256)
    nms_build_global_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                            const float* __restrict__ cls, uint32_t* __restrict__ pred, int k,
                            int words, float iou_thresh) {
  const int lane = threadIdx.x & 31;
  const int img = blockIdx.y;
  const int kpad = words * 32;
  const long long base = (long long)img * k;
  uint32_t* ipred = pred + (long long)img * words * kpad;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + base;
  const float nan = __int_as_float(0x7fffffff);
  const bool thresh_nonneg = iou_thresh >= 0.0f;
  const long long tiles = (long long)words * (words + 1) / 2;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (long long t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); t < tiles; t += warps) {
    int bi = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while ((long long)(bi + 1) * (bi + 2) / 2 <= t) ++bi;
    while ((long long)bi * (bi + 1) / 2 > t) --bi;
    const int bj = (int)(t - (long long)bi * (bi + 1) / 2);
    const int j = bj * 32 + lane;
    const bool jlive = j < k && valid[base + j] != 0;
    const float4 cb = jlive ? bx[j] : make_float4(nan, nan, nan, nan);
    const float4 jb = j < k ? bx[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float jarea = __fmul_rn(clamp0(__fsub_rn(jb.z, jb.x)), clamp0(__fsub_rn(jb.w, jb.y)));
    const float jcls = kClassWise && j < k ? cls[base + j] : 0.0f;
    const int i_me = bi * 32 + lane;
    const uint32_t rows_live = __ballot_sync(kFull, i_me < k && valid[base + i_me] != 0);
    uint32_t mine = 0u;  // lane r: pred[bj][32 bi + r]
    for (uint32_t rows = rows_live; rows; rows &= rows - 1u) {
      const int r = __ffs(rows) - 1;
      const int i = bi * 32 + r;
      const float4 rb = bx[i];
      const float rarea = __fmul_rn(clamp0(__fsub_rn(rb.z, rb.x)), clamp0(__fsub_rn(rb.w, rb.y)));
      const float rcls = kClassWise ? cls[base + i] : 0.0f;
      const bool same = !kClassWise || fabsf(__fsub_rn(rcls, jcls)) < 0.5f;
      if (kClassWise && !__any_sync(kFull, same)) continue;
      const float iw = clamp0(__fsub_rn(min_nan(cb.z, rb.z), max_nan(cb.x, rb.x)));
      const float ih = clamp0(__fsub_rn(min_nan(cb.w, rb.w), max_nan(cb.y, rb.y)));
      const float inter = __fmul_rn(iw, ih);
      if (thresh_nonneg && !__any_sync(kFull, same && inter > 0.0f)) continue;
      const float uni = __fsub_rn(__fadd_rn(jarea, rarea), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      uint32_t word = __ballot_sync(kFull, same && iou > iou_thresh);
      if (bi == bj) word &= (1u << r) - 1u;  // the diagonal tile: only j < i
      if (lane == r) mine = word;
    }
    ipred[(long long)bj * kpad + bi * 32 + lane] = mine;
  }
}

// The large-K scan, one block of 32 warps per image: for word b, warp w ORs
// pred[w'][i] & kept[w'] over the earlier words w' = w, w + 32, ..., the
// block reduces the 32 partial words, and warp 0 decides the word's 32
// candidates by the rounds of ballots of the shared-memory kernel.
__global__ void __launch_bounds__(1024)
    nms_scan_global_kernel(const uint8_t* __restrict__ valid, const uint32_t* __restrict__ pred,
                           uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ uint32_t kept[];  // [words], then partial[32][32]
  uint32_t* partial = kept + words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kpad = words * 32;
  const long long base = (long long)blockIdx.x * k;
  const uint32_t* ipred = pred + (long long)blockIdx.x * words * kpad;
  for (int b = 0; b < words; ++b) {
    const int i = b * 32 + lane;
    uint32_t ext = 0u;
    for (int w = warp; w < b; w += 32) ext |= ipred[(long long)w * kpad + i] & kept[w];
    partial[warp * 32 + lane] = ext;
    __syncthreads();
    if (warp == 0) {
#pragma unroll 8
      for (int w = 1; w < 32; ++w) ext |= partial[w * 32 + lane];
      const uint32_t live = __ballot_sync(kFull, i < k && valid[base + i] != 0);
      const uint32_t intra = ipred[(long long)b * kpad + i];
      uint32_t undecided = __ballot_sync(kFull, ext == 0u) & live;
      uint32_t killed = ~undecided, kept_b = 0u;
      while (undecided) {
        const bool mine = (undecided >> lane) & 1u;
        const uint32_t now_kept = __ballot_sync(kFull, mine && (intra & ~killed) == 0u);
        const uint32_t now_killed =
            __ballot_sync(kFull, mine && (intra & (kept_b | now_kept)) != 0u);
        kept_b |= now_kept;
        killed |= now_killed;
        undecided &= ~(now_kept | now_killed);
      }
      if (lane == 0) kept[b] = kept_b;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    keep[base + i] = (uint8_t)((kept[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 = ok).  `cls`
// may be null (class-agnostic suppression).  Requires k >= 1 and 16-byte
// aligned boxes.  K <= 1024 builds the bitmask in shared memory; a larger K
// needs `scratch`, n * words * 32 * words u32 (words = ceil(K / 32): K²/8
// bytes an image), where the bitmask is built in global memory.
extern "C" int yolo_nms_keep(const float* boxes, const uint8_t* valid, const float* cls,
                             uint8_t* keep, uint32_t* scratch, int n, int k, float iou_thresh,
                             int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaSuccess;
  if (k < 1 || reinterpret_cast<uintptr_t>(boxes) % 16 != 0 || (k > kMaxK && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int words = (k + 31) / 32;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k > kMaxK) {
    const long long tiles = (long long)words * (words + 1) / 2;
    const int per_image = tiles / 8 + 1 < 1024 ? (int)(tiles / 8 + 1) : 1024;  // 8 warps a block
    const dim3 grid(per_image, n);
    if (cls)
      nms_build_global_kernel<true><<<grid, 256, 0, s>>>(boxes, valid, cls, scratch, k, words,
                                                          iou_thresh);
    else
      nms_build_global_kernel<false><<<grid, 256, 0, s>>>(boxes, valid, cls, scratch, k, words,
                                                           iou_thresh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nms_scan_global_kernel<<<n, 1024, (words + 32 * 32) * 4, s>>>(valid, scratch, keep, k,
                                                                   words);
    return (int)cudaGetLastError();
  }
  const int kpad = words * 32;
  const int tiles = words * (words + 1) / 2;
  const int threads = 32 * min(32, tiles);
  const int smem = kpad * (16 + 8) + words * 4 + words * kpad * 4;
  static int smem_set[64] = {};  // the opt-in already granted, by device
  if (smem > 48 * 1024 && (device < 0 || device >= 64 || smem > smem_set[device])) {
    err = cudaFuncSetAttribute(nms_keep_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(nms_keep_scan_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = smem;
  }
  if (cls)
    nms_keep_scan_kernel<true><<<n, threads, smem, s>>>(boxes, valid, cls, keep, k, words,
                                                        iou_thresh);
  else
    nms_keep_scan_kernel<false><<<n, threads, smem, s>>>(boxes, valid, cls, keep, k, words,
                                                         iou_thresh);
  return (int)cudaGetLastError();
}
