// K2: batched greedy-NMS keep mask, one block per image: the whole block
// builds the overlap bitmask in 32 x 32 tiles, then one warp scans it.
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;  // ops/kernels.py: MAX_NMS_K; at most 32 words, one a lane

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

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 = ok).  `cls`
// may be null (class-agnostic suppression).  Requires 1 <= k <= 1024 and
// 16-byte aligned boxes.
extern "C" int yolo_nms_keep(const float* boxes, const uint8_t* valid, const float* cls,
                             uint8_t* keep, int n, int k, float iou_thresh, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > kMaxK || reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int words = (k + 31) / 32;
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
    nms_keep_scan_kernel<true><<<n, threads, smem, (cudaStream_t)stream>>>(
        boxes, valid, cls, keep, k, words, iou_thresh);
  else
    nms_keep_scan_kernel<false><<<n, threads, smem, (cudaStream_t)stream>>>(
        boxes, valid, cls, keep, k, words, iou_thresh);
  return (int)cudaGetLastError();
}
