// Fused YOLO head decode + score, one thread per output row.
//
// Replaces the Pallas TPU kernel pytorch_yolo_tpu/ops/pallas_kernels.py:
// decode_score_head (body _decode_score_kernel).  One head's raw logits
// (N, Gy, Gx, A*(5+C)) fp32 become (N, Gy*Gx*A, 8) rows
// [x1, y1, x2, y2, obj, cls_score, cls_id, rank], cell-major, anchor-minor.
//
// What bounds it on an H100: memory.  Every input byte is read once and
// the output is 8/(5+C) of the input (yolov3@416, batch 128: ~463 MB in,
// ~44 MB out, ~0.15 ms at 3.35 TB/s).  The arithmetic is a few exps per row.
//
// Design: a block stages its rows_per_block consecutive input rows
// (row-major, so one contiguous span of rows_per_block*(5+C) floats) into
// shared memory with coalesced loads, eight in flight per thread, then
// each thread decodes one row from shared memory.  A row is 5+C floats; for C = 80 that is 85 words,
// an odd stride, so the per-thread row walk hits 32 distinct banks.  The
// two 16-byte output stores of neighbouring threads are contiguous.  The
// TPU kernel's geometry and column-index input arrays were Mosaic
// workarounds; here (cx, cy, anchor) come from the row index and the
// anchors travel as a kernel argument.
//
// Arithmetic order follows the plain torch version
// (ops/kernels.py: decode_score_head_ref); products that feed a sum use the
// _rn intrinsics so nvcc cannot contract them into FMAs.  expf differs from
// torch's exp in the last ulps only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAnchors = 8;
constexpr int kUnroll = 8;

struct Anchors {
  float wh[2 * kMaxAnchors];
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__global__ void decode_score_kernel(const float* __restrict__ raw, float* __restrict__ out,
                                    long long total_rows, int rows, int gx, int num_anchors,
                                    int num_classes, Anchors anchors, float stride,
                                    float scale_xy, float shift_xy, int new_coords,
                                    int cls_act, int score_mode,
                                    long long out_batch_stride) {
  extern __shared__ float tile[];
  const int attrs = 5 + num_classes;
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const int nrows = (int)min((long long)blockDim.x, total_rows - row0);

  // Stage the block's rows: kUnroll independent loads per thread in flight
  // before their shared-memory stores, so the copy is not latency-bound.
  const float* src = raw + row0 * attrs;
  const int count = nrows * attrs;
  const int step = blockDim.x;
  int e = threadIdx.x;
  for (; e + (kUnroll - 1) * step < count; e += kUnroll * step) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + e + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) tile[e + u * step] = v[u];
  }
  for (; e < count; e += step) tile[e] = __ldg(src + e);
  __syncthreads();
  if ((int)threadIdx.x >= nrows) return;

  const long long t = row0 + threadIdx.x;
  const int n = (int)(t / rows);
  const int r = (int)(t - (long long)n * rows);
  const int cell = r / num_anchors;
  const int a = r - cell * num_anchors;
  const float cx = (float)(cell % gx);
  const float cy = (float)(cell / gx);
  const float pw = anchors.wh[2 * a];
  const float ph = anchors.wh[2 * a + 1];
  const float* p = tile + threadIdx.x * attrs;

  float tx, ty, bw, bh, obj;
  if (new_coords) {
    tx = p[0];
    ty = p[1];
    const float w2 = __fmul_rn(2.0f, p[2]);
    const float h2 = __fmul_rn(2.0f, p[3]);
    bw = __fmul_rn(pw, __fmul_rn(w2, w2));
    bh = __fmul_rn(ph, __fmul_rn(h2, h2));
    obj = p[4];
  } else {
    tx = sigmoid_f(p[0]);
    ty = sigmoid_f(p[1]);
    bw = __fmul_rn(pw, expf(p[2]));
    bh = __fmul_rn(ph, expf(p[3]));
    obj = sigmoid_f(p[4]);
  }
  const float bx = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(tx, scale_xy), shift_xy), cx), stride);
  const float by = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(ty, scale_xy), shift_xy), cy), stride);

  // Best class logit and the first column that reaches it.
  const float* logit = p + 5;
  float best = logit[0];
  int best_id = 0;
  for (int c = 1; c < num_classes; ++c) {
    const float v = logit[c];
    if (v > best) {
      best = v;
      best_id = c;
    }
  }
  float score;
  if (cls_act == 1) {  // softmax: p(best) = 1 / sum exp(l - l_best)
    float sum = 0.0f;
    for (int c = 0; c < num_classes; ++c) sum = __fadd_rn(sum, expf(__fsub_rn(logit[c], best)));
    score = __fdiv_rn(1.0f, sum);
  } else if (cls_act == 2) {  // linear
    score = best;
  } else {  // sigmoid is monotonic, so it commutes with the max
    score = sigmoid_f(best);
  }
  const float rank = score_mode ? __fmul_rn(obj, score) : obj;

  const float hw = __fmul_rn(bw, 0.5f);
  const float hh = __fmul_rn(bh, 0.5f);
  float4* dst = reinterpret_cast<float4*>(out + (long long)n * out_batch_stride + (long long)r * 8);
  dst[0] = make_float4(__fsub_rn(bx, hw), __fsub_rn(by, hh), __fadd_rn(bx, hw), __fadd_rn(by, hh));
  dst[1] = make_float4(obj, score, (float)best_id, rank);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// `anchors_wh` is a host array of 2*num_anchors floats (w0, h0, w1, h1, ...).
extern "C" int yolo_decode_score(const float* raw, float* out, int n, int gy, int gx,
                                 int num_anchors, int num_classes, const float* anchors_wh,
                                 float stride, float scale_xy, float shift_xy, int new_coords,
                                 int cls_act, int score_mode, long long out_batch_stride,
                                 int rows_per_block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (num_anchors < 1 || num_anchors > kMaxAnchors) return (int)cudaErrorInvalidValue;
  Anchors anchors = {};
  for (int i = 0; i < 2 * num_anchors; ++i) anchors.wh[i] = anchors_wh[i];
  const int rows = gy * gx * num_anchors;
  const long long total_rows = (long long)n * rows;
  if (total_rows == 0) return 0;
  const size_t smem = (size_t)rows_per_block * (5 + num_classes) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (total_rows + rows_per_block - 1) / rows_per_block;
  decode_score_kernel<<<(unsigned)blocks, rows_per_block, smem, (cudaStream_t)stream>>>(
      raw, out, total_rows, rows, gx, num_anchors, num_classes, anchors, stride, scale_xy,
      shift_xy, new_coords, cls_act, score_mode, out_batch_stride);
  return (int)cudaGetLastError();
}
