// K4's packed route: the int8 RGB stem, a 3x3 conv of C = 3 int8 channels
// (stride 1 or 2, pad 1) into O <= 32 outputs (O % 8 == 0), with K4's
// serving epilogue.
//
// Replaces, for this one shape, XLA's int8 conv in
// pytorch_yolo_tpu/ops/quant.py: quantized_conv (_mxu, then the dequant /
// bias / activation / requant epilogue; quant.py:564-622), as K4 does for
// every other int8 conv (int8_conv.cu).  It has no Pallas source.  The first
// int8 conv of every ladder family at early skip 0 (yolov2, yolov2-tiny at
// stride 1, yolov4-tiny at stride 2; ops/kernels.py: igemm_plan's "packed")
// runs here instead of on the mma.sync byte path, which walked K as 9
// taps of a 64-byte slice with 3 useful bytes each, filled byte by byte.
//
// What bounds it on an H100: HBM.  yolov2's stem at batch 128 and 416^2
// reads 66 MB of input and writes 708 MB of int8 outputs (0.23 ms at 3.35
// TB/s) for 45 G int8 ops (0.02 ms of tensor-core time).  After the bytes
// come the instructions a pixel costs: the epilogue's ~10 an output
// (dequant, bias, activation, requant) for 32 outputs, and building a row
// of A.  The design:
//   * A: one 32-byte row per output pixel, the 27 int8 values of its 3x3x3
//     window in W's (KH, KW, C) order and 5 zeros: one
//     wgmma.m64n32k32.s32.s8.s8 covers all of K.  W is one 32 x 32 tile
//     (rows past O zero, so that the epilogue's 32-column chunk is whole),
//     built once a block.  A tile is 256 consecutive output pixels (two m64
//     blocks a consumer warpgroup), on a persistent grid; a tile that
//     crosses an image walks on into the next;
//   * loads: a tile's pixels fall in "segments", runs of one output row.
//     For each segment and tap row the producer warpgroup copies the input
//     row's span the segment reads ((len - 1) * stride + 3 pixels) into a
//     "slot" of shared memory with 16-byte cp.async copies of the aligned
//     pieces that cover it, and notes the slot's phase (its first byte's
//     address mod 16) in a table; the next tile's copies are in flight
//     while this one is built (two slice buffers).  At stride 1 each input
//     byte then comes from L2 three times (once a tap row), not nine;
//   * a row of A is three 9-byte runs, one a tap row: each run is read from
//     its slot as three 32-bit words and aligned with funnel shifts; a tap
//     in the padding (row outside the image, or the first or last pixel of
//     a run outside it) is masked to zero; rows past M are zero.  The rows
//     are stored with the 32-byte swizzle wgmma reads, conflict-free.  A
//     pixel's segment and column come from multiply-high divisions by Wo
//     and Ho (FastDiv), not from the hardware's 64-bit division;
//   * two blocks an SM where their slices fit (80 registers a thread): a
//     block's producer builds while the other's epilogue stores;
//   * the epilogue is the wgmma core's (int8_wgmma.cuh: stage_chunk,
//     store_rows_for, epilogue_column), unchanged: dequant, fp32 bias and
//     activation with explicit __fmaf_rn, rintf, requant to int8 at a
//     scalar or per-channel out_scale, or fp32 / int32 out, each pixel's
//     outputs written by neighbouring threads (a warp writes 4 rows).  Its
//     bits are the plain version's (ops/kernels.py: int8_conv_ref).
// No [shortcut] operand and no split groups: a stem has neither, and
// igemm_plan keeps such a call on its old core.  The numpy model of A
// (ops/kernels.py: int8_packed_rows) follows the producer step by step.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, device
// time at batch 128, 416^2, int8 out): yolov2's stem 0.95 ms (24 % of its
// bound; the mma.sync byte path 45.06, cuDNN bf16 + bias + leaky 6.49, K5's
// packed route 1.20), yolov2-tiny's (16 outputs) 0.95, yolov4-tiny's (s2)
// 0.25.  Where the time goes (tools/packed_stem_variants.py, yolov2's):
// without the epilogue 0.36 ms, without building A 0.90, without the
// copies 0.95, one block an SM 1.44: K4's epilogue sets the pace, and at
// O = 16 half of each of its warps idles (a thread takes four columns of
// four rows whatever O is).

#include "int8_igemm.cuh"
#include "int8_wgmma.cuh"

namespace {
namespace pk {

constexpr int kC = 3;          // input channels
constexpr int kRun = 3 * kC;   // bytes of a window's tap row: 3 pixels of 3 channels
constexpr int kK = 32;         // bytes of a row of A and of W: 27 values, 5 zeros
constexpr int kN = 32;         // W's rows (wgmma N); rows past O are zero
constexpr int kRows = 256;     // output pixels a tile: two m64 blocks a consumer warpgroup
constexpr int kStages = 4;     // ring of A tiles
constexpr int kProducerBar = 3;  // named barrier of the producer warpgroup (1, 2: consumers)

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b),
               "r"(c), "r"(d));
}

__device__ __forceinline__ void st_shared_s32(uint32_t addr, int v) {
  asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// Bytes of a slice's slot: the span of (min(Wo, kRows) - 1) * stride + 3
// pixels, plus up to 15 bytes before it (the first copy's alignment) and
// 16 after (the last copy's, and the last run's three words).  Mirrors
// ops/kernels.py: int8_packed_slot.
__host__ __device__ inline int slot_bytes(int wo, int stride) {
  const int cols = wo < kRows ? wo : kRows;
  return (((cols - 1) * stride + 3) * kC + 31 + 15) & ~15;
}

// Segments a tile can touch: runs of one output row (ops/kernels.py:
// int8_packed_max_segments).
__host__ __device__ inline int max_segments(int wo) { return 1 + (kRows - 1 + wo - 1) / wo; }

// Bytes of one slice buffer: 3 slots a segment, then each slot's phase
// (ops/kernels.py: int8_packed_smem).
__host__ __device__ inline int buffer_bytes(int wo, int stride) {
  return (3 * max_segments(wo) * (slot_bytes(wo, stride) + 4) + 15) & ~15;
}

struct Layout {
  static constexpr int kABytes = kRows * kK;                                  // 8 KB a stage
  static constexpr int kOffB = kStages * kABytes;                             // W: 32 rows
  static constexpr int kOffStaging = kOffB + kN * kK;                         // 2 x 64 rows
  static constexpr int kOffBars = kOffStaging + 2 * 64 * wg::kStageRow;       // full, then empty
  static constexpr int kOffSlices = kOffBars + 2 * kStages * 8;               // two slice buffers
  static constexpr int kFixed = kOffSlices + 1024;                            // + alignment slack
  static_assert(kOffSlices % 16 == 0, "slices need the copies' 16-byte grid");
};

// Division of n in [0, 2^31) by a divisor fixed for the launch, as a
// multiply-high and a shift (the round-up method of CUTLASS's FastDivmod;
// ops/kernels.py: _div_by).  The producer divides a pixel's place by
// Wo and an output row by Ho for every row it builds.
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

inline FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;  // ceil(log2(d))
    while ((1 << l) < d) ++l;
    f.mul = (uint32_t)(((1ull << (31 + l)) + (unsigned)d - 1) / (unsigned)d);
    f.shr = (uint32_t)(l - 1);
  }
  return f;
}

__device__ __forceinline__ int div_by(const FastDiv& f, int n) {
  return f.d == 1 ? n : (int)(__umulhi((uint32_t)n, f.mul) >> f.shr);
}

// Kernel parameters, passed by value as one __grid_constant__.
struct Params {
  IgemmArgs a;
  long long x_bytes;  // of x: a copy never reads past it
  int tiles;          // ceil(M / kRows)
  int slot;           // slot_bytes(Wo, stride)
  int phases;         // offset of the slots' phases in a slice buffer: 3 * max_segments * slot
  int slices;         // buffer_bytes(Wo, stride)
  FastDiv wo, ho;
};

// One tile: its first output pixel, its pixels, the output row (n * Ho +
// oh) of its first pixel, that pixel's column, and the pixels of its first
// segment.  M < 2^31 (IgemmArgs.M is an int), so all of it is 32-bit.
struct Tile {
  int m0, len, row0, ow0, first;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile tl;
  tl.m0 = t * kRows;
  tl.len = min(kRows, p.a.M - tl.m0);
  tl.row0 = div_by(p.wo, tl.m0);
  tl.ow0 = tl.m0 - tl.row0 * p.a.Wo;
  tl.first = min(p.a.Wo - tl.ow0, tl.len);
  return tl;
}

// Starts the copies of tile t's slices into the buffer at shared address
// `buf`: warp w takes slices w, w + 4, ... (slice 3 j + r: segment j, tap
// row r); its lanes the 16-byte pieces of a slice.  Segment j is output
// row row0 + j from column ow_a (ow0, or 0 after the first), its span the
// input pixels from column ow_a * stride - 1, at byte offset L0 in x (in
// the padding, or before x itself, at the left edge); the byte at x + L0 +
// b lands at slot + (L0 & 15) + b, and lane 0 writes the slot's phase L0 &
// 15 to the buffer's table, or -1 for a tap row in the padding (masked,
// never read).
__device__ __forceinline__ void load_slices(const Params& p, int t, uint32_t buf, int warp,
                                            int lane) {
  const IgemmArgs& a = p.a;
  const Tile tl = tile_at(p, t);
  const int segs = div_by(p.wo, tl.ow0 + tl.len - 1) + 1;
  for (int z = warp; z < 3 * segs; z += 4) {
    const int j = z / 3;
    const int out_row = tl.row0 + j;
    const int n = div_by(p.ho, out_row);
    const int ih = (out_row - n * a.Ho) * a.stride - 1 + (z - 3 * j);
    const int ow_a = j == 0 ? tl.ow0 : 0;
    const long long row = (long long)(n * a.H + ih) * a.W * kC;
    const long long L0 = row + (ow_a * a.stride - 1) * kC;
    const bool in = (unsigned)ih < (unsigned)a.H;
    if (lane == 0) st_shared_s32(buf + p.phases + 4 * z, in ? (int)(L0 & 15) : -1);
    if (!in) continue;
    const int seg = j == 0 ? tl.first : min(a.Wo, tl.len - tl.first - (j - 1) * a.Wo);
    const int lo = max(ow_a * a.stride - 1, 0);
    const int hi = min((ow_a + seg - 1) * a.stride + 1, a.W - 1);
    const long long b1 = row + (hi + 1) * kC;
    const long long from = L0 & ~15LL;
    const uint32_t slot = buf + (uint32_t)(z * p.slot);
    for (long long g = ((row + lo * kC) & ~15LL) + 16 * lane; g < b1; g += 16 * 32)
      wg::cp_async16_u32(slot + (uint32_t)(g - from), a.x + g,
                         (int)min(16LL, p.x_bytes - g));
  }
}

// Byte offset of 16-byte chunk `chunk` (0, 1) of row `row` in a tile of
// 32-byte rows with the 32-byte swizzle: the chunk index XOR address bit 7.
__device__ __forceinline__ uint32_t sw32_chunk(int row, int chunk) {
  return (uint32_t)(row * kK + ((chunk ^ ((row >> 2) & 1)) * 16));
}

// Shared-memory matrix descriptor of a K-major tile of 32-byte rows with
// the 32-byte swizzle: 8-row groups 256 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// d = A(64 x 32, smem) * W(32 x 32, smem)^T: all of K in one step.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

// Row i of tile tl's A (its 32 bytes as 8 words) from the slices at `buf`:
// pixel i is column ow of segment j (ow0 + i = j Wo + ow); tap row r's 9
// bytes start (ow - ow_a) * stride pixels into the slot of slice 3 j + r.
__device__ __forceinline__ void build_row(const Params& p, const Tile& tl, uint32_t buf, int i,
                                          uint32_t (&w)[8]) {
  const IgemmArgs& a = p.a;
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = 0;
  if (i >= tl.len) return;  // past M
  const int c = tl.ow0 + i;
  const int j = div_by(p.wo, c);
  const int ow = c - j * a.Wo;
  const bool left = ow == 0;                       // the run's first pixel is column -1
  const bool right = ow * a.stride + 1 >= a.W;     // its last pixel is column W
  const uint32_t slots = buf + (uint32_t)(3 * j * p.slot) +
                         (uint32_t)((ow - (j == 0 ? tl.ow0 : 0)) * a.stride * kC);
  const uint32_t phases = buf + (uint32_t)(p.phases + 12 * j);
  uint32_t x0[3], x1[3], x2[3];                    // each run's bytes 0-3, 4-7 and 8
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int phase = (int)lds32(phases + 4 * r);
    x0[r] = x1[r] = x2[r] = 0;
    if (phase >= 0) {
      const uint32_t pos = slots + (uint32_t)(r * p.slot + phase);
      const uint32_t at = pos & ~3u;
      const uint32_t sh = (pos & 3u) * 8;
      const uint32_t u0 = lds32(at), u1 = lds32(at + 4), u2 = lds32(at + 8);
      x0[r] = __funnelshift_r(u0, u1, sh);
      x1[r] = __funnelshift_r(u1, u2, sh);
      x2[r] = (u2 >> sh) & 0xFFu;
      if (left) x0[r] &= 0xFF000000u;
      if (right) {
        x1[r] &= 0x0000FFFFu;
        x2[r] = 0;
      }
    }
  }
  // runs 0, 1, 2 at bytes 0, 9, 18; bytes 27-31 zero
  w[0] = x0[0];
  w[1] = x1[0];
  w[2] = x2[0] | x0[1] << 8;
  w[3] = __funnelshift_r(x0[1], x1[1], 24);
  w[4] = x1[1] >> 24 | x2[1] << 8 | x0[2] << 16;
  w[5] = __funnelshift_r(x0[2], x1[2], 16);
  w[6] = x1[2] >> 16 | x2[2] << 16;
}

__global__ void __launch_bounds__(wg::kThreads, 2) packed_kernel(__grid_constant__ const Params p) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;  // swizzled tiles need their alignment
  const uint32_t full0 = base + L::kOffBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  const IgemmArgs& a = p.a;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  // W as 32 rows of 32 bytes, (KH, KW, C) order, zero past O and past 27
  if (threadIdx.x < 2 * kN) {
    const int o = threadIdx.x / 2, chunk = threadIdx.x % 2;
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int k = 16 * chunk + e;
      if (o < a.O && k < 3 * kRun)
        v[e / 4] |= (uint32_t)(uint8_t)a.w[o * 3 * kRun + k] << (8 * (e % 4));
    }
    sts128(base + L::kOffB + sw32_chunk(o, chunk), v[0], v[1], v[2], v[3]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full0 + 8 * s, 128);  // every producer thread's rows
      wg::mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // W for wgmma
  __syncthreads();

  if (role == 0) {
    // ---------------- producer warpgroup: slices, then A ----------------
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t bufs[2] = {base + L::kOffSlices, base + L::kOffSlices + (uint32_t)p.slices};
    if ((int)blockIdx.x < p.tiles) load_slices(p, blockIdx.x, bufs[0], warp, lane);
    cp_async_commit();
    int stage = 0, k = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++k) {
      const uint32_t buf = bufs[k & 1];
      if (t + (int)gridDim.x < p.tiles)
        load_slices(p, t + gridDim.x, bufs[(k + 1) & 1], warp, lane);
      cp_async_commit();
      cp_async_wait_one();                    // this thread's copies of tile t have landed
      wg::named_barrier(kProducerBar, 128);   // and every other thread's
      const Tile tl = tile_at(p, t);
      wg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t sa = base + stage * L::kABytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = tid + 128 * h;  // neighbouring threads, neighbouring pixels
        uint32_t w[8];
        build_row(p, tl, buf, i, w);
        sts128(sa + sw32_chunk(i, 0), w[0], w[1], w[2], w[3]);
        sts128(sa + sw32_chunk(i, 1), w[4], w[5], w[6], w[7]);
      }
      // the generic proxy's writes, before the async proxy's wgmma reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg::mbar_arrive(full0 + 8 * stage);
      wg::named_barrier(kProducerBar, 128);  // the slices of tile t are read: their buffer is free
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---------------- consumer warpgroups: wgmma, then K4's epilogue ----------------
    const int cw = role - 1;  // rows [128 cw, 128 cw + 128) of the tile
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + L::kOffStaging + cw * 64 * wg::kStageRow;
    const float sx = (a.mode >= kEpiF32 && a.sx != nullptr) ? *a.sx : 1.0f;
    const float os_scalar = (a.mode == kEpiI8 && !a.out_scale_vec) ? *a.out_scale : 1.0f;
    const bool homogeneous = a.act == kLeaky || a.act == kRelu || a.act == kLinear;
    const int out_bytes = (a.mode == kEpiAcc || a.mode == kEpiF32) ? 4 : 1;
    const wg::Epi epi = {static_cast<char*>(a.out), a.M, a.O, a.pre, a.mul, a.sh,
                         ((long long)a.O * out_bytes) % 16 == 0, nullptr, 4};
    // this thread's four output columns 4q .. 4q + 3, for the whole run
    const int q = tid % 8;
    const float3 f0 = wg::epilogue_column(a, 4 * q, sx, os_scalar, homogeneous);
    const float3 f1 = wg::epilogue_column(a, 4 * q + 1, sx, os_scalar, homogeneous);
    const float3 f2 = wg::epilogue_column(a, 4 * q + 2, sx, os_scalar, homogeneous);
    const float3 f3 = wg::epilogue_column(a, 4 * q + 3, sx, os_scalar, homogeneous);
    const float4 mul = make_float4(f0.x, f1.x, f2.x, f3.x);
    const float4 add = make_float4(f0.y, f1.y, f2.y, f3.y);
    const float4 div = make_float4(f0.z, f1.z, f2.z, f3.z);
    const float none[1] = {0.0f};
    int acc[2][16];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[b][i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      wg::mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sa = base + stage * L::kABytes + cw * 128 * kK;
      wg::wgmma_fence();
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wg::fence_regs(acc[b]);
        wgmma_n32(acc[b], sw32_desc(sa + b * 64 * kK), sw32_desc(base + L::kOffB));
      }
      wg::wgmma_commit();
      wg::wgmma_wait_all();
#pragma unroll
      for (int b = 0; b < 2; ++b) wg::fence_regs(acc[b]);
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      // Epilogue, one m64 block at a time through the staging rows.
      const long long m0 = (long long)t * kRows + cw * 128;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wg::named_barrier(bar_id, 128);  // the last block's pieces are written
        wg::stage_chunk<0, false>(acc[b], none, false, 1.0f, staging, warp, lane);
        wg::named_barrier(bar_id, 128);
        if (4 * q < a.O)
          wg::store_rows_for<false, false>(a.mode, a.act, epi, staging + 16 * q, tid / 8,
                                           m0 + 64 * b, 4 * q, mul, add, div);
      }
    }
  }
}

}  // namespace pk
}  // namespace

// Launches K4's packed route on `stream`; returns a CUDA error code (0 =
// ok).  `args` points to an IgemmArgs (ops/kernels.py: _IgemmArgs) of a 3x3
// conv of 3 channels, stride 1 or 2, pad 1, 8 <= O <= 32 with O % 8 == 0,
// one channel group, no [shortcut] operand, x and out 16-byte aligned
// (ops/kernels.py: igemm_plan's "packed").
extern "C" int yolo_int8_conv_packed(const void* args, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const IgemmArgs& a = *static_cast<const IgemmArgs*>(args);
  if (a.C != pk::kC || a.KH != 3 || a.KW != 3 || a.pad != 1 || (a.stride != 1 && a.stride != 2) ||
      a.O < 8 || a.O > pk::kN || a.O % 8 != 0 || a.groups != 1 || a.sxg != nullptr ||
      a.shortcut != nullptr || a.Ho != (a.H - 1) / a.stride + 1 ||
      a.Wo != (a.W - 1) / a.stride + 1 || (long long)a.M != (long long)a.batch * a.Ho * a.Wo ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.out) % 16)
    return (int)cudaErrorInvalidValue;
  if (a.M == 0) return 0;
  pk::Params p{};
  p.a = a;
  p.x_bytes = (long long)a.batch * a.H * a.W * pk::kC;
  p.tiles = (a.M + pk::kRows - 1) / pk::kRows;
  p.slot = pk::slot_bytes(a.Wo, a.stride);
  p.phases = 3 * pk::max_segments(a.Wo) * p.slot;
  p.slices = pk::buffer_bytes(a.Wo, a.stride);
  p.wo = pk::fast_div(a.Wo);
  p.ho = pk::fast_div(a.Ho);
  const int bytes = pk::Layout::kFixed + 2 * p.slices;
  constexpr int kDevices = 64;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  if (device < 0 || device >= kDevices || bytes > 232448) return (int)cudaErrorInvalidValue;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {  // once per device: the most any launch asks for
      const cudaError_t err = cudaFuncSetAttribute(
          pk::packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
      if (err != cudaSuccess) return (int)err;
      ready[device] = true;
    }
  }
  // persistent blocks, as many as fit on the SMs (two where the slices
  // are small): one block's producer builds while the other's epilogue
  // stores
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pk::packed_kernel, wg::kThreads,
                                                      bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = per_sm * sms < p.tiles ? per_sm * sms : p.tiles;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  pk::packed_kernel<<<grid, wg::kThreads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
