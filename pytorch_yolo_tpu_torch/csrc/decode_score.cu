// K1: fused YOLO head decode + score over every head of a model in one
// launch, reading the heads in their serving dtype (bf16 or fp32).
//
// Replaces the Pallas TPU kernel pytorch_yolo_tpu/ops/pallas_kernels.py:
// decode_score_head (body _decode_score_kernel).  Each head's raw map
// (N, Gy, Gx, A*(5+C)) becomes (N, Gy*Gx*A, 8) rows
// [x1, y1, x2, y2, obj, cls_score, cls_id, rank], cell-major, anchor-minor,
// written into its row range of one (N, D, 8) fp32 output.
//
// What bounds it on an H100: memory.  Every input byte is read once and
// the output is 8 fp32 a row (yolov3@416, batch 128, bf16 heads: 231.7 MB
// in, 43.6 MB out, 0.082 ms at 3.35 TB/s; fp32 heads 463.4 MB in).  The
// arithmetic is a few exps and a class max a row.
//
// Design:
//   * one launch for up to kMaxHeads heads.  A head's rows are one
//     contiguous span of N*Gy*Gx*A rows of attrs = 5+C values; a tile is
//     kTileRows consecutive rows of one head, and tiles are numbered across
//     heads (the table comes from ops/kernels.py: decode_plan);
//   * a persistent grid (as many blocks as fit on the SMs, three a SM for
//     bf16 yolov3) walks the tiles round-robin.  One thread of a block
//     copies each tile into a ring of 2-4 shared-memory stages with one 1-D
//     bulk copy (cp.async.bulk ... mbarrier::complete_tx), so tile t+1..t+S-1
//     are in flight while tile t is decoded.  A tile whose byte count is not
//     a multiple of 16 (a head's last, ragged tile) is loaded by the block
//     with plain loads instead;
//   * one thread decodes one row from shared memory.  bf16 values are
//     widened in registers (exact: bf16 -> fp32 is a shift), so the numbers
//     are those of the fp32 cast of the same heads.  Rows are attrs values
//     apart, 85 for C = 80: an odd word stride in fp32, so consecutive rows
//     hit distinct banks; in bf16 a warp takes rows of one parity (2*lane +
//     warp%2), an odd word stride again, where consecutive rows would meet
//     2-way conflicts;
//   * one thread walks a row's C logits in order, keeping the first index
//     of the max: one thread a row issues fewer instructions than splitting
//     the row over lanes and reducing with shuffles, and the 8-12 warps a
//     SM hide the compare chain's latency.
// The arithmetic after the load follows the plain version
// (ops/kernels.py: decode_score_head_ref) operation for operation (the _rn
// intrinsics keep nvcc from contracting products into FMAs; expf differs
// from torch's exp in the last ulps only), and bf16 heads give the rows of
// their fp32 widening bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "device_guard.cuh"

namespace {

constexpr int kMaxHeads = 8;         // ops/kernels.py: MAX_HEADS
constexpr int kMaxAnchors = 8;       // ops/kernels.py: MAX_ANCHORS
constexpr int kTileRows = 128;       // ops/kernels.py: DECODE_TILE_ROWS; one thread a row
constexpr int kThreads = kTileRows;  // 4 warps
constexpr int kMaxStages = 4;
constexpr int kRingTarget = 75 * 1024;  // ring bytes a block aims at: three blocks a SM
constexpr int kBarBytes = 128;          // the stages' mbarriers, ahead of the ring
constexpr int kSmemLimit = 232448;      // 227 KB, what a block may use

// One head of the launch; ops/kernels.py: _DecodeHead, field for field.
struct DecodeHead {
  const void* raw;       // (N, Gy, Gx, A*(5+C)) contiguous, 16-byte aligned
  long long rows_total;  // N * rows
  long long out_row0;    // the head's first row in an image of the output
  int rows;              // rows an image, Gy*Gx*A
  int gx, num_anchors, attrs, num_classes, cls_act, new_coords;
  int first_tile;        // tiles are numbered across heads
  float stride, scale_xy, shift_xy;
  float anchors[2 * kMaxAnchors];  // w0, h0, w1, h1, ...
};

// ops/kernels.py: _DecodeArgs.  `stages` and `stage_bytes` are set by the
// launcher.
struct DecodeArgs {
  DecodeHead head[kMaxHeads];
  float* out;                  // (N, D, 8), 16-byte aligned rows
  long long out_batch_stride;  // floats from one image's rows to the next
  int num_heads, total_tiles, score_mode;
  int stages, stage_bytes;
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

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 1-D bulk copy global -> shared; completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {  // bf16 bits -> fp32, exact
  return __uint_as_float((uint32_t)v << 16);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The row a thread decodes in a tile: consecutive rows for fp32, rows of
// one parity a warp for bf16 (see the header).
template <typename T>
__device__ __forceinline__ int thread_row() {
  if (sizeof(T) == 4) return threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return 2 * lane + (warp & 1) + 64 * (warp >> 1);
}

__device__ __forceinline__ int head_of(const DecodeArgs& args, int tile) {
  int h = 0;
  while (h + 1 < args.num_heads && tile >= args.head[h + 1].first_tile) ++h;
  return h;
}

// Bytes of a tile's bulk copy, or 0 when it takes the plain path.
template <typename T>
__device__ __forceinline__ uint32_t bulk_bytes(const DecodeHead& h, int nrows) {
  const uint32_t bytes = (uint32_t)nrows * (uint32_t)h.attrs * (uint32_t)sizeof(T);
  return bytes % 16 == 0 ? bytes : 0u;
}

// Thread 0: start the copy of `tile` into the stage at `dst`.
template <typename T>
__device__ void issue_tile(const DecodeArgs& args, int tile, unsigned char* dst, uint32_t bar) {
  if (tile >= args.total_tiles) return;
  const DecodeHead& h = args.head[head_of(args, tile)];
  const long long row0 = (long long)(tile - h.first_tile) * kTileRows;
  const int nrows = (int)min((long long)kTileRows, h.rows_total - row0);
  const uint32_t bytes = bulk_bytes<T>(h, nrows);
  if (bytes == 0) return;
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy(smem_u32(dst), static_cast<const T*>(h.raw) + row0 * h.attrs, bytes, bar);
}

template <typename T>
__device__ __forceinline__ void decode_row(const T* __restrict__ p, const DecodeHead& h, int t,
                                           const DecodeArgs& args) {
  const int n = t / h.rows;
  const int r = t - n * h.rows;
  const int cell = r / h.num_anchors;
  const int a = r - cell * h.num_anchors;
  const float cx = (float)(cell % h.gx);
  const float cy = (float)(cell / h.gx);
  const float pw = h.anchors[2 * a];
  const float ph = h.anchors[2 * a + 1];

  float tx, ty, bw, bh, obj;
  if (h.new_coords) {
    tx = widen(p[0]);
    ty = widen(p[1]);
    const float w2 = __fmul_rn(2.0f, widen(p[2]));
    const float h2 = __fmul_rn(2.0f, widen(p[3]));
    bw = __fmul_rn(pw, __fmul_rn(w2, w2));
    bh = __fmul_rn(ph, __fmul_rn(h2, h2));
    obj = widen(p[4]);
  } else {
    tx = sigmoid_f(widen(p[0]));
    ty = sigmoid_f(widen(p[1]));
    bw = __fmul_rn(pw, expf(widen(p[2])));
    bh = __fmul_rn(ph, expf(widen(p[3])));
    obj = sigmoid_f(widen(p[4]));
  }
  const float bx =
      __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(tx, h.scale_xy), h.shift_xy), cx), h.stride);
  const float by =
      __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(ty, h.scale_xy), h.shift_xy), cy), h.stride);

  // Best class logit and the first column that reaches it.
  const T* logit = p + 5;
  const int num_classes = h.num_classes;
  float best = widen(logit[0]);
  int best_id = 0;
#pragma unroll 8
  for (int c = 1; c < num_classes; ++c) {
    const float v = widen(logit[c]);
    if (v > best) {
      best = v;
      best_id = c;
    }
  }
  float score;
  if (h.cls_act == 1) {  // softmax: p(best) = 1 / sum exp(l - l_best)
    float sum = 0.0f;
    for (int c = 0; c < num_classes; ++c)
      sum = __fadd_rn(sum, expf(__fsub_rn(widen(logit[c]), best)));
    score = __fdiv_rn(1.0f, sum);
  } else if (h.cls_act == 2) {  // linear
    score = best;
  } else {  // sigmoid is monotonic, so it commutes with the max
    score = sigmoid_f(best);
  }
  const float rank = args.score_mode ? __fmul_rn(obj, score) : obj;

  const float hw = __fmul_rn(bw, 0.5f);
  const float hh = __fmul_rn(bh, 0.5f);
  float4* dst = reinterpret_cast<float4*>(args.out + (long long)n * args.out_batch_stride +
                                          (h.out_row0 + r) * 8);
  dst[0] = make_float4(__fsub_rn(bx, hw), __fsub_rn(by, hh), __fadd_rn(bx, hw), __fadd_rn(by, hh));
  dst[1] = make_float4(obj, score, (float)best_id, rank);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_score_ring_kernel(const __grid_constant__ DecodeArgs args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = smem + kBarBytes;
  const int stages = args.stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int it = 0; it < stages; ++it)
      issue_tile<T>(args, blockIdx.x + it * gridDim.x, ring + it * args.stage_bytes, bars + 8 * it);
  }

  const int row = thread_row<T>();
  uint32_t phases = 0;  // bit s: the parity of stage s's next completion
  int it = 0;
  for (int tile = blockIdx.x; tile < args.total_tiles; tile += gridDim.x, ++it) {
    const int s = it % stages;
    const DecodeHead& h = args.head[head_of(args, tile)];
    const long long row0 = (long long)(tile - h.first_tile) * kTileRows;
    const int nrows = (int)min((long long)kTileRows, h.rows_total - row0);
    T* buf = reinterpret_cast<T*>(ring + s * args.stage_bytes);
    if (bulk_bytes<T>(h, nrows) == 0) {  // ragged tile: plain loads by the whole block
      const T* src = static_cast<const T*>(h.raw) + row0 * h.attrs;
      for (int e = tid; e < nrows * h.attrs; e += kThreads) buf[e] = src[e];
      // these generic writes come before a later bulk copy into the stage
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    } else {
      mbar_wait(bars + 8 * s, (phases >> s) & 1u);
      phases ^= 1u << s;
    }
    if (row < nrows) decode_row<T>(buf + row * h.attrs, h, (int)row0 + row, args);
    __syncthreads();  // every thread is done with stage s
    if (tid == 0)
      issue_tile<T>(args, tile + stages * gridDim.x, ring + s * args.stage_bytes, bars + 8 * s);
  }
}

// One device's launch set-up, for one instantiation: the most dynamic
// shared memory the kernel is allowed there (only ever raised, so a launch
// that another thread set up for less stays valid), and the grid of each
// shared-memory size launched there (a few: one a head dtype and class count).
constexpr int kDevices = 64;
constexpr int kSizes = 8;
struct DeviceGrids {
  int allowed = 0, used = 0;
  int smem[kSizes] = {}, grid[kSizes] = {};
};

template <typename T>
int launch(DecodeArgs args, int device, cudaStream_t stream) {
  if (args.num_heads < 1 || args.num_heads > kMaxHeads) return (int)cudaErrorInvalidValue;
  int max_attrs = 0, tiles = 0;
  for (int i = 0; i < args.num_heads; ++i) {
    const DecodeHead& h = args.head[i];
    if (h.num_anchors < 1 || h.num_anchors > kMaxAnchors || h.attrs != 5 + h.num_classes ||
        h.first_tile != tiles || h.rows_total > 0x7fffffffLL || h.rows < 1 ||
        reinterpret_cast<uintptr_t>(h.raw) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    tiles += (int)((h.rows_total + kTileRows - 1) / kTileRows);
    max_attrs = max(max_attrs, h.attrs);
  }
  if (tiles != args.total_tiles || reinterpret_cast<uintptr_t>(args.out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  args.stage_bytes = (kTileRows * max_attrs * (int)sizeof(T) + 127) / 128 * 128;
  args.stages = min(kMaxStages, max(2, kRingTarget / args.stage_bytes));
  const int smem = kBarBytes + args.stages * args.stage_bytes;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;

  // one table a device, under a lock: launches that alternate between the
  // cards of a mesh or between sizes, or come from several threads, keep
  // every card's grids and never lower another launch's allowance
  static std::mutex mu;
  static DeviceGrids grids[kDevices];
  if (device < 0 || device >= kDevices) return (int)cudaErrorInvalidDevice;
  int most = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    DeviceGrids& g = grids[device];
    for (int i = 0; i < min(g.used, kSizes) && !most; ++i)
      if (g.smem[i] == smem) most = g.grid[i];
    if (!most) {
      cudaError_t err;
      if (smem > g.allowed) {
        err = cudaFuncSetAttribute(decode_score_ring_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        g.allowed = smem;
      }
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_score_ring_kernel<T>,
                                                          kThreads, smem);
      if (err != cudaSuccess) return (int)err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return (int)err;
      most = max(1, per_sm) * sms;
      const int slot = g.used++ % kSizes;  // past kSizes sizes, the oldest goes
      g.smem[slot] = smem;
      g.grid[slot] = most;
    }
  }
  const int grid = min(tiles, most);
  decode_score_ring_kernel<T><<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K1 over the heads of `args` (a DecodeArgs) of `elem_bytes`-byte
// values (2: bf16, 4: fp32) on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int yolo_decode_score(const void* args, int elem_bytes, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const DecodeArgs& a = *static_cast<const DecodeArgs*>(args);
  if (elem_bytes == 2) return launch<uint16_t>(a, device, (cudaStream_t)stream);
  if (elem_bytes == 4) return launch<float>(a, device, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
