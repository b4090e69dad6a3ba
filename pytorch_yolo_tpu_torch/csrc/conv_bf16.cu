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
// (C = 3, 32 outputs, 416x416) are bound by HBM.  The design, on the
// helpers of the int8 core (int8_wgmma.cuh):
//   * one producer warpgroup, two consumer warpgroups, persistent blocks, a
//     ring of stages with a full and an empty mbarrier each; a 128 x BN
//     block tile (BN = 64 up to 64 outputs, else 128; on the "im2col16",
//     halo and packed routes fitted to O: 32, 48, 64, 80 or 128, so that
//     40 outputs run on 48 columns and 80 or 160 on 80; on "im2col_pad" 80
//     where O is a multiple of 160), each consumer
//     warpgroup 64 x BN with wgmma.m64nBNk16.f32.bf16.bf16 from swizzled
//     K-major tiles;
//   * A's route, chosen from the shapes alone (ops/kernels.py:
//     conv_bf16_plan), and what bounds it:
//       - "im2col" (every 3x3 conv with C % 64 == 0), "im2col_pad" (C % 64
//         == 32, C >= 160) and "im2col32" (C = 32 and 96): one TMA im2col
//         box a stage, 128 output pixels x 64 channels of one tap (128-byte
//         rows, 128-byte swizzle; im2col32: one tap's 32 channels, 64-byte
//         rows), the tap as the box's offsets, the conv's stride as the
//         traversal stride, the padding as the box's corners.  The wrapper
//         passes the corners and a table of each stage's (first channel,
//         tap) (ops/kernels.py: conv_bf16_im2col, conv_bf16_stages); the
//         producer works out only its tile's first pixel.  A tile that
//         crosses an image walks on into the next; one past M reads zeros.
//         One thread issues every load.  A stage takes an SM 0.50-0.90 us
//         against 0.28 of MMA time at BN = 128 (PERF.md section 6).
//         "im2col_pad" reads a tap's C channels in ceil(C / 64) such boxes,
//         the last one's upper 32 channels TMA's zero fill (x keeps its real
//         C in the map; W is repacked once to 64 ceil(C / 64) channels, zero
//         past C): C = 160 takes 27 stages a tile instead of 45, for 20 %
//         more MMA work, 4-13 % faster at the same tiles; at C = 96 (every
//         second box half zero) it gained nothing, and im2col32 keeps those
//         convs and C = 32;
//       - "tma" (1x1 stride 1): A as the (M, C) matrix it is; bound by HBM;
//       - "im2col16" (the other C % 8 == 0: yolov4x-mish's and yolov4-p7's
//         C = 40 and 80, yolov2-tiny's 16, the s2d stem's 12 padded to 16):
//         four TMA im2col boxes a stage, each 128 pixels x 16 channels of
//         one tap in its own 32-byte-swizzled sub-tile and one k16 wgmma;
//         a tap's last box of C % 16 == 8 channels reads its last 8 as
//         zeros (TMA's out-of-bounds fill), W is repacked once in box order
//         with zero channels there, and W's N-tile stays in shared memory
//         beside a ring of 4-8 stages (a conv whose W does not fit goes to
//         the gather).  One thread issues every load; no copy of x, no
//         proxy fence.  Bound by the boxes' traffic into shared memory (each
//         input pixel once a tap: 2.1-2.7 TB/s over the card; 80-byte
//         pixels' boxes straddle 32-byte sectors) and, at 80 mish outputs,
//         by the epilogue's arithmetic (PERF.md section 6);
//       - "halo" (3x3 pad 1 stride 1, C % 16 == 8, at most 48 outputs, a
//         tile of BN = 32 or 48: conv_bf16_halo_kernel in
//         conv_bf16_halo.cu): a 4 x 32 block of output pixels a tile,
//         its input pixels brought once by one tiled TMA box, A built by
//         ldmatrix at per-lane pixel addresses, wgmma with A from
//         registers.  It moves a ninth of the boxes' bytes, and beats them
//         where they bound the conv (p7's 768^2 40 -> 40, batch 8: 1.41
//         against 2.00 ms in turns, chip_smoke.py phase 13); where an
//         80-column mish epilogue sets the pace the boxes' deeper ring hides
//         more of it, and they stay (yolov4x-mish's 160^2 80 -> 80, batch
//         64: 0.91 against 1.03 ms at BN = 80, so the halo route is built
//         only for the tiles of up to 48 outputs);
//       - "packed" (the RGB stem, 3x3 x 3 channels, up to 64 outputs): 27
//         values and 5 zeros a 64-byte row, built by the producer from the
//         3-channel pixels, W one BN x 32 tile loaded once a block, 256
//         pixels a tile, BN = 32, 48 or 64 (conv_bf16_packed_kernel in
//         conv_bf16_packed.cu); bound by HBM and the producer's 2-byte
//         loads, and with mish by the epilogue's arithmetic;
//       - "gather" (only a conv with more boxes than the stage table
//         holds, or an "im2col16" conv whose W does not fit beside the
//         ring; no zoo conv): 16-byte cp.async copies by the producer
//         warpgroup, K walked flat;
//   * two-level accumulation: the tensor cores chain P = kPromote = 4
//     stages (256 of K) into a fresh partial set, then the consumer adds it
//     into the tile's fp32 sums with __fadd_rn, once a group: the MMAs drain
//     once a group, not after each stage.  Each stage is committed on its
//     own and released as soon as its MMAs are done (wgmma.wait_group 1),
//     which keeps the ring full; holding a group's stages to its end was
//     ~15 % slower (PERF.md).  The tensor cores' own accumulation is not an IEEE sum
//     (one chain over K = 4608 gave 99.70 % outputs equal to the exact sum
//     rounded once); chaining 4 stages keeps >= 99.975 % at every
//     tools/k5_accuracy.py shape (P = 1: 99.984 %, 2: 99.985 %; cuDNN's fp32
//     conv 99.945-99.977 %).  Registers: ptxas holds a thread of the
//     384-thread block to 168 (setmaxnreg moves them at run time but does
//     not raise what ptxas allocates), so a consumer keeps the tile's BN / 2
//     sums and one partial set of BN / 2: 128 at BN = 128.  A 256-column
//     tile needs 192 (one n128 set, or two alternating n64 sets so that one's
//     promotion overlaps the other's MMAs): it spilled and ran slower than
//     two 128-column tiles, and at BN = 128 one n128 set ran faster than two
//     alternating n64 sets (exploratory runs on the card).  The two consumer
//     warpgroups overlap each other's promotion;
//   * a cluster of 2 CTAs on neighbouring M-tiles of one N-tile: each CTA
//     loads half of the B stage by TMA multicast for both, so B's L2 reads
//     halve; the empty barriers count both CTAs' consumers (remote arrives
//     without a cluster-scope release: with one the kernel ran far slower).
//     Along M because N-tiles exist only from 256 outputs on; A stays per
//     CTA.  Without the cluster the bf16 step ran 6 % slower (PERF.md).
//     On "im2col_pad" at BN = kPairBN (80; O a multiple of 160) the cluster
//     runs along N instead: both CTAs take one M-tile and neighbouring
//     80-column tiles, each loads half of A's rows (a 64-pixel box from
//     its half's first pixel) by multicast for both and its own B, so a
//     CTA's im2col requests halve and A crosses L2 once an M-tile, not once
//     an N-tile; at yolov4x-mish's 80^2 160 -> 160 conv, batch 64, 0.60 ms
//     against 1.04 at BN = 128 (whose second tile held 32 live columns)
//     and cuDNN's 0.76 (PERF.md section 6);
//   * the epilogue stages 32-column chunks of fp32 sums in shared memory;
//     each thread then turns four columns of one row into bf16 outputs,
//     __fadd_rn(sum, bias), the activation of int8_igemm.cuh (the JAX
//     formulas), __float2bfloat16_rn, and writes them with one 8-byte store.
//     The store loop is compiled once per (activation, shortcut).  On the
//     tiles fitted to O a chunk of 16 or 8 live columns spreads over 4 or
//     2 threads a row (not 8 with most idle), and each thread computes its
//     rows' activations together before it stores them (store_chunk_fitted).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py
// phase 13, device time at batch 128): 3x3 s1 52^2 128->256 0.47 ms (cuDNN
// bf16 conv + bias + leaky 0.65), 26^2 256->512 0.40 (cuDNN 0.47), 13^2
// 512->1024 0.37 (cuDNN 0.39), the stem 1.23 (3.7 before this design),
// the 1x1 52^2 256->128 0.12; the bf16 batch-128 step 45.8 -> 32.9 ms.
// The result equals the plain version (ops/kernels.py: conv_bf16_ref, an
// fp32 conv of the same bf16 operands) up to the order of the fp32 sums:
// a bf16 output differs only where those sums straddle a rounding boundary.

#include "conv_bf16.cuh"

namespace {
namespace cb {

// A consumer warp's release of a stage it has read: lane 0 arrives on the
// stage's empty barrier in every CTA of the cluster, whose B loads write it.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if (lane != 0) return;
  for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(bar, c);
}

template <int kRoute, int BN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(wg::kThreads, 1)
    conv_bf16_kernel(__grid_constant__ const Params p) {
  constexpr int kRow = row_bytes(kRoute);
  using L = Layout<BN, kRow>;
  constexpr int kStages = L::kStages;
  constexpr bool kGather = kRoute == kRouteGather;
  constexpr bool kBoxed = kRoute == kRouteIm2col16;  // W's N-tile resident
  constexpr bool kIm2col = kRoute == kRouteIm2col || kRoute == kRouteIm2col32 ||
                           kRoute == kRouteIm2colPad || kBoxed;
  // the cluster's CTAs on one M-tile and neighbouring N-tiles, A's halves
  // multicast (else on neighbouring M-tiles of one N-tile, B's halves)
  constexpr bool kPairN = kRoute == kRouteIm2colPad && BN == kPairBN;
  constexpr int kChunks = (BN + wg::kChunk - 1) / wg::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = wg::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw_addr);
  // the Layout's offsets, or kRouteIm2col16's from the host
  const int nstages = kBoxed ? p.ring : kStages;
  const uint32_t off_b = kBoxed ? p.off_w : L::kOffB;
  const uint32_t off_staging = kBoxed ? p.off_staging : L::kOffStaging;
  const uint32_t off_params = kBoxed ? p.off_params : L::kOffParams;
  const uint32_t full0 = base + (kBoxed ? p.off_bars : L::kOffBars);
  const uint32_t empty0 = full0 + 8 * nstages;
  const uint32_t wbar = empty0 + 8 * nstages;  // kRouteIm2col16: W's load
  const ConvBf16Args& a = p.a;
  const int role = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  // a pair's N-tiles: one, or kCluster neighbours on kPairN
  const int pair_n = kPairN ? (p.tiles_n + kCluster - 1) / kCluster : p.tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstages; ++s) {
      // full: the TMA thread's expect_tx arrival (+ 128 cp.async arrivals for
      // the gather); empty: lane 0 of each of the 8 consumer warps of both
      // CTAs, since either CTA's B load writes both CTAs' stage.
      wg::mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      wg::mbar_init(empty0 + 8 * s, 8 * kCluster);
    }
    if (kBoxed) wg::mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (role == 0) {
    // ---------------- producer warpgroup ----------------
    if constexpr (kGather) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::kProducerRegs));
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kIssueRegs));
      if (tid != 0) return;  // one thread issues every TMA load
    }
    wg::RowInfo* rows = reinterpret_cast<wg::RowInfo*>(smem + L::kOffRows);
    const int chunk = tid & 7;  // 16-byte chunk (8 channels) of a 128-byte row
    const uint32_t swz = (uint32_t)((chunk ^ ((tid >> 3) & 7)) * 16);
    const int taps = a.KH * a.KW;
    const int hw = a.Ho * a.Wo;
    if constexpr (kBoxed) {
      // W's N-tile, once: the host makes the cluster count a multiple of
      // tiles_n, so every pair of this cluster has the same N-tile.  K past
      // W's end and rows past O read as zero.
      const int n0 = (cluster % p.tiles_n) * BN;
      wg::mbar_arrive_expect_tx(wbar, p.ksteps * L::kBBytes);
      for (int j = 0; j < p.ksteps; ++j)
        for (int h = 0; h < kCluster; ++h)
          wg::tma_load_2d(base + off_b + j * L::kBBytes + h * (BN / kCluster) * kRow, &p.tma_b,
                          wbar, j * kRow, n0 + h * (BN / kCluster));
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int pair = cluster; pair < p.pairs; pair += clusters) {
      // this CTA's M-tile and N-tile of the cluster's pair; an M-tile past M
      // (an odd count) reads zeros and stores nothing, as does an N-tile
      // past O on kPairN (an odd count)
      const int m0 = (kPairN ? pair / pair_n : kCluster * (pair / p.tiles_n) + (int)rank) * wg::kBM;
      const int n0 = (kPairN ? kCluster * (pair % pair_n) + (int)rank : pair % p.tiles_n) * BN;
      // im2col: the first pixel of the tile (of its half on kPairN); the box
      // walks on from it, into the next image where the tile crosses one,
      // and past the last image (zeros) where it ends past M.
      int img = 0, h0 = 0, w0 = 0;
      if constexpr (kIm2col) {
        const int row0 = m0 + (kPairN ? (int)rank * (wg::kBM / kCluster) : 0);
        img = row0 / hw;
        const int rem = row0 - img * hw;
        const int oh = rem / a.Wo;
        h0 = a.lo_h + oh * a.stride;
        w0 = a.lo_w + (rem - oh * a.Wo) * a.stride;
      }
      if constexpr (kGather) {
        wg::named_barrier(3, 128);  // every producer thread is done with the last tile's rows
        const int m = m0 + tid;
        wg::RowInfo e;
        if (m < a.M) {
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
        const uint32_t sb = base + off_b + stage * L::kBBytes;
        if (tid == 0) {
          // the last stage of kRouteIm2col16 may hold fewer than kBoxes boxes
          const int boxes = kBoxed ? min(kBoxes, a.stages - s * kBoxes) : 0;
          wg::mbar_arrive_expect_tx(full, kGather  ? L::kBBytes
                                          : kBoxed ? boxes * kBoxBytes
                                                   : L::kABytes + L::kBBytes);
          // This CTA's half of the B stage, for both CTAs (kPairN: its own
          // B); K past its end reads as zero (TMA's out-of-bounds fill).
          if constexpr (kPairN)
            wg::tma_load_2d(sb, &p.tma_b, full, s * kRow, n0);
          else if constexpr (!kBoxed)
            tma_load_2d_multicast(sb + rank * (BN / kCluster) * kRow, &p.tma_b, full, s * kRow,
                                  n0 + (int)rank * (BN / kCluster),
                                  (uint16_t)((1 << kCluster) - 1));
          if constexpr (kRoute == kRouteTma) wg::tma_load_2d(sa, &p.tma_a, full, s * wg::kBK, m0);
          if constexpr (kBoxed) {
            // 16 channels of one tap a box; channels past C read as zero
            for (int j = 0; j < boxes; ++j) {
              const uint32_t e = a.stage_tab[s * kBoxes + j];
              tma_im2col_4d(sa + j * kBoxBytes, &p.tma_a, full, (int)(e & 0xFFFF), w0, h0, img,
                            (uint16_t)((e >> 16) & 0xFF), (uint16_t)(e >> 24));
            }
          } else if constexpr (kPairN) {
            // this CTA's half of the tile's rows, for both CTAs
            const uint32_t e = a.stage_tab[s];
            tma_im2col_4d_multicast(sa + rank * (wg::kBM / kCluster) * kRow, &p.tma_a, full,
                                    (int)(e & 0xFFFF), w0, h0, img,
                                    (uint16_t)((e >> 16) & 0xFF), (uint16_t)(e >> 24),
                                    (uint16_t)((1 << kCluster) - 1));
          } else if constexpr (kIm2col) {
            const uint32_t e = a.stage_tab[s];  // kRow / 2 channels of one tap
            tma_im2col_4d(sa, &p.tma_a, full, (int)(e & 0xFFFF), w0, h0, img,
                          (uint16_t)((e >> 16) & 0xFF), (uint16_t)(e >> 24));
          }
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
        if (++stage == nstages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    if constexpr (kGather) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::kConsumerRegs));
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kIssueConsumerRegs));
    }
    const int cw = role - 1;  // rows [64 cw, 64 cw + 64) of the block tile
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + cw;
    const uint32_t staging = base + off_staging + cw * 64 * wg::kStageRow;
    float* prm = reinterpret_cast<float*>(smem + off_params) + cw * BN;
    const uint32_t prm_addr = wg::smem_u32(prm);
    const bool vec_ok = a.O % 4 == 0;  // a row of bf16 outputs is 8-byte aligned

    float acc[BN / 2];   // the tile's fp32 sums
    float part[BN / 2];  // a group's sums, from the tensor cores
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

    if (kBoxed) wg::mbar_wait(wbar, 0);  // W's N-tile is in
    int stage = 0;
    uint32_t phase = 0;
    for (int pair = cluster; pair < p.pairs; pair += clusters) {
      const int m0 = (kPairN ? pair / pair_n : kCluster * (pair / p.tiles_n) + (int)rank) * wg::kBM;
      const int n0 = (kPairN ? kCluster * (pair % pair_n) + (int)rank : pair % p.tiles_n) * BN;
      // Groups of g <= kPromote stages: the tensor cores chain a group's MMAs
      // into `part` from zero, each stage committed on its own so that it is
      // released as soon as its MMAs are done; then the consumer adds `part`
      // into the tile's fp32 sums (the tile's first group takes it as it is).
      for (int s = 0; s < p.ksteps; s += kPromote) {
        const int g = min(kPromote, p.ksteps - s);
        uint32_t done = 0;  // the empty barrier of the stage before, once read
        wg::wgmma_fence();
        fence_f(part);
#pragma unroll
        for (int pp = 0; pp < kPromote; ++pp) {
          if (pp < g) {
            wg::mbar_wait(full0 + 8 * stage, phase);
            // cp.async wrote the gathered A through the generic proxy; wgmma
            // reads through the async proxy.
            if (kGather) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            // B: the ring's stage, or the K step's chunk of the resident W
            const uint32_t sb = base + off_b + (kBoxed ? s + pp : stage) * L::kBBytes;
            if constexpr (kBoxed) {
              // box kk: this warpgroup's 64 rows of its sub-tile, against
              // the 16 of K at byte 32 kk of B's rows
              const uint32_t sa = base + stage * L::kABytes + cw * 64 * kBoxRow;
              const int boxes = min(kBoxes, a.stages - (s + pp) * kBoxes);
#pragma unroll
              for (int kk = 0; kk < kBoxes; ++kk)
                if (kk < boxes)
                  wgmma_bf16<BN>(part, sw32_desc(sa + kk * kBoxBytes), sw_desc<kRow>(sb + 32 * kk),
                                 (pp == 0 && kk == 0) ? 0 : 1);
            } else {
              const uint32_t sa = base + stage * L::kABytes + cw * 64 * kRow;
#pragma unroll
              for (int kk = 0; kk < kRow / 32; ++kk)
                wgmma_bf16<BN>(part, sw_desc<kRow>(sa + 32 * kk), sw_desc<kRow>(sb + 32 * kk),
                               (pp == 0 && kk == 0) ? 0 : 1);
            }
            wg::wgmma_commit();
            if (pp > 0) {
              wgmma_wait<1>();  // the stage before is read: free it
              release(done, lane);
            }
            done = empty0 + 8 * stage;
            if (++stage == nstages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        wgmma_wait<0>();
        fence_f(part);
        release(done, lane);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = s == 0 ? part[i] : __fadd_rn(acc[i], part[i]);
      }

      // Epilogue: the tile's biases, then 32-column chunks (the last one of
      // a 48- or 80-column tile 16 wide): stage the fp32 sums, then turn
      // them into bf16 outputs four columns a thread.
      wg::named_barrier(bar_id, 128);  // the last tile's pieces are written
      for (int c = tid; c < BN; c += 128) prm[c] = n0 + c < a.O ? a.bias[n0 + c] : 0.0f;
#pragma unroll 1
      for (int ch = 0; ch < kChunks; ++ch) {
        if (n0 + ch * wg::kChunk >= a.O) break;  // uniform over the warpgroup
        if (ch > 0) wg::named_barrier(bar_id, 128);  // the last chunk's pieces are written
        switch (ch) {
#define CB_STAGE(CH)                                                                   \
  case CH:                                                                             \
    if constexpr (CH < kChunks)                                                        \
      stage_chunk<CH, BN / 2, chunk_width<BN, CH>()>(acc, staging, warp, lane);         \
    break;
          CB_STAGE(0) CB_STAGE(1) CB_STAGE(2) CB_STAGE(3)
#undef CB_STAGE
        }
        wg::named_barrier(bar_id, 128);
        if constexpr (BN % wg::kChunk != 0) {
          const int live = min(min(wg::kChunk, BN - ch * wg::kChunk), a.O - n0 - ch * wg::kChunk);
          store_chunk_fitted(a, vec_ok, staging, prm_addr + 4 * ch * wg::kChunk, tid,
                             LinearRows{(long long)m0 + 64 * cw, a.M}, n0 + ch * wg::kChunk, live);
        } else {
          // 8 pieces of 4 columns per staged row; a quarter-warp reads one row.
          const int q = tid % 8;
          const int col = ch * wg::kChunk + 4 * q;
          const int o0 = n0 + col;
          if (o0 < a.O) {
            const uint4 bb = wg::lds128(prm_addr + 4 * col);
            const float4 bias = make_float4(__uint_as_float(bb.x), __uint_as_float(bb.y),
                                            __uint_as_float(bb.z), __uint_as_float(bb.w));
            store_rows_for(a, vec_ok, staging + 16 * q, tid / 8,
                           LinearRows{(long long)m0 + 64 * cw, a.M}, o0, bias);
          }
        }
      }
    }
  }
  cluster_sync();
}

template <int kRoute, int BN>
cudaError_t launch_one(const Params& p, int device, int sms, cudaStream_t s) {
  constexpr int kDevices = 64;
  constexpr bool kBoxed = kRoute == kRouteIm2col16;
  static std::mutex mu;
  static bool ready[kDevices] = {};
  auto kernel = conv_bf16_kernel<kRoute, BN>;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device]) {  // once per instantiation and device
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kBoxed ? kSmemLimit : Layout<BN, row_bytes(kRoute)>::kBytes);
      if (err != cudaSuccess) return err;
      ready[device] = true;
    }
  }
  // whole clusters, at most one CTA an SM; with W resident, a multiple of
  // tiles_n clusters, so that each keeps one N-tile (more N-tiles than the
  // SMs hold clusters: one cluster each, in waves)
  int most = sms / kCluster;
  if (kBoxed) most = (most < p.tiles_n ? 1 : most / p.tiles_n) * p.tiles_n;
  const int grid = kCluster * (p.pairs < most ? p.pairs : most);
  kernel<<<grid, wg::kThreads, kBoxed ? p.smem_bytes : Layout<BN, row_bytes(kRoute)>::kBytes,
           s>>>(p);
  return cudaGetLastError();
}

template <int kRoute>
cudaError_t launch_bn(const Params& p, int bn, int device, int sms, cudaStream_t s) {
  if (bn == 64) return launch_one<kRoute, 64>(p, device, sms, s);
  return launch_one<kRoute, 128>(p, device, sms, s);
}

// kRouteIm2col16's tiles: BN fitted to O (ops/kernels.py: conv_bf16_plan).
template <int kRoute>
cudaError_t launch_boxed(const Params& p, int bn, int device, int sms, cudaStream_t s) {
  switch (bn) {
    case 32:
      return launch_one<kRoute, 32>(p, device, sms, s);
    case 48:
      return launch_one<kRoute, 48>(p, device, sms, s);
    case 64:
      return launch_one<kRoute, 64>(p, device, sms, s);
    case 80:
      return launch_one<kRoute, 80>(p, device, sms, s);
    default:
      return launch_one<kRoute, 128>(p, device, sms, s);
  }
}

// kRouteIm2col16's shared memory for a bn-column tile and K of p.ksteps
// 64-wide chunks: as many A stages (up to kMaxRing) as fit beside W's
// N-tile; false where fewer than kMinRing fit (ops/kernels.py:
// conv_bf16_ring mirrors it, and the plan sends such a conv to the gather).
inline bool resident_layout(Params& p, int bn) {
  const int w_bytes = p.ksteps * bn * 128;
  const int fixed = 2 * 64 * wg::kStageRow + 2 * bn * 4 + wg::kBM * 16 + 8 * (2 * kMaxRing + 1);
  const int ring = (kSmemLimit - 1024 - w_bytes - fixed) / (wg::kBM * kBoxRow * kBoxes);
  if (ring < kMinRing) return false;
  p.ring = ring < kMaxRing ? ring : kMaxRing;
  p.off_w = p.ring * wg::kBM * kBoxRow * kBoxes;
  p.off_staging = p.off_w + w_bytes;
  p.off_params = p.off_staging + 2 * 64 * wg::kStageRow;
  p.off_bars = p.off_params + 2 * bn * 4 + wg::kBM * 16;
  p.smem_bytes = p.off_bars + 8 * (2 * p.ring + 1) + 1024;
  return true;
}

}  // namespace cb
}  // namespace

// csrc/conv_bf16_packed.cu and conv_bf16_halo.cu: the packed and halo
// routes' launches.
extern "C" int yolo_conv_bf16_packed(const void* args, int bn, int device, int sms,
                                     void* stream);
extern "C" int yolo_conv_bf16_halo(const void* args, int bn, int device, int sms,
                                   void* stream);

// Launches K5 on `stream` with a `bn`-column tile and A by `route`
// (cb::Route: 0 the 16-byte gather, 1 TMA for a 1x1 stride-1 unpadded conv,
// 2 TMA im2col for C % 64 == 0, 3 the packed RGB stem, 4 TMA im2col a tap's
// 32 channels a stage (C % 64 == 32), 5 TMA im2col boxes of 16 channels,
// four a stage, beside W's N-tile resident in shared memory (ops/kernels.py:
// conv_bf16_ring says where it fits), 6 a 3x3 stride-1 conv from halo
// tiles (ops/kernels.py: conv_bf16_halo), 7 TMA im2col boxes of 64 channels
// for C % 64 == 32, C > 32, the last of a tap half past C); returns a CUDA
// error code (0 = ok).  `bn`: 64 or 128; on route 7 also 80 (the cluster on
// one M-tile, A's halves multicast); 32, 48 or 64 (>= O) on the packed
// route; 32, 48, 64, 80 or 128 on route 5; 32 or 48 (>= O) on route 6.
// `args` points to a ConvBf16Args (ops/kernels.py: _ConvBf16Args).
// Requires C % 8 == 0 (C = 3 on the packed route), on routes 5-6 W as (O,
// KH, KW, 16 ceil(C / 16)) and on route 7 as (O, KH, KW, 64 ceil(C / 64))
// with zero channels past C (ops/kernels.py: conv_bf16 repacks it), and x,
// w, shortcut and out 16-byte aligned (ops/kernels.py: conv_bf16 checks and
// pads).
extern "C" int yolo_conv_bf16(const void* args, int bn, int route, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t err = cudaSuccess;
  const cb::ConvBf16Args& a = *static_cast<const cb::ConvBf16Args*>(args);
  const bool packed = route == cb::kRoutePacked;
  const bool halo = route == cb::kRouteHalo;
  const bool boxed = route == cb::kRouteIm2col16;
  const bool padded = route == cb::kRouteIm2colPad;
  const bool im2col = route == cb::kRouteIm2col || route == cb::kRouteIm2col32;
  const bool pair_n = padded && bn == cb::kPairBN;
  const int row = cb::row_bytes(route);
  const int box_c = boxed ? 16 : row / 2;  // channels of a stage-table entry
  const long long taps = (long long)a.KH * a.KW;
  const bool bn_ok = packed ? (bn == 32 || bn == 48 || bn == 64) && a.O <= bn
                     : halo ? (bn == 32 || bn == 48) && a.O <= bn
                     : boxed ? bn == 32 || bn == 48 || bn == 64 || bn == 80 || bn == 128
                     : padded ? bn == 64 || bn == cb::kPairBN || bn == 128
                             : bn == 64 || bn == 128;
  if ((!packed && a.C % 8 != 0) || !bn_ok || route < 0 || route > 7 ||
      (halo && (a.KH != 3 || a.KW != 3 || a.pad != 1 || a.stride != 1)) ||
      (packed && (a.KH != cb::kPackedTaps || a.KW != cb::kPackedTaps || a.C != cb::kPackedC)) ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      reinterpret_cast<uintptr_t>(a.out) % 16 || reinterpret_cast<uintptr_t>(a.shortcut) % 16 ||
      (route == cb::kRouteTma && (a.KH != 1 || a.KW != 1 || a.stride != 1 || a.pad != 0)) ||
      (im2col && (a.C % box_c != 0 || (long long)a.stages * box_c != taps * a.C)) ||
      ((im2col || boxed || padded) && a.stages > cb::kMaxStages) ||
      (padded && (a.C % 64 != 32 || a.C < 96)) ||
      ((boxed || padded) && (long long)a.stages != taps * ((a.C + box_c - 1) / box_c)))
    return (int)cudaErrorInvalidValue;
  if (a.M == 0 || a.O == 0) return 0;
  cb::Params p{};
  p.a = a;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (packed) return yolo_conv_bf16_packed(args, bn, device, sms, stream);
  if (halo) return yolo_conv_bf16_halo(args, bn, device, sms, stream);
  // K of W's rows: KH KW C, or the boxes' channels (16 or 64 each) on
  // routes 5 and 7
  const long long k = boxed || padded ? (long long)a.stages * box_c : taps * a.C;
  // B in boxes of half a stage: each CTA of a cluster loads one half for
  // both; on one M-tile, each CTA its own
  if (!cb::encode_rows(&p.tma_b, a.w, 2 * k, a.O, 2 * k, row, pair_n ? bn : bn / cb::kCluster))
    return (int)cudaErrorInvalidValue;
  if (route == cb::kRouteTma &&
      !cb::encode_rows(&p.tma_a, a.x, 2LL * a.C, a.M, 2LL * a.C, row, wg::kBM))
    return (int)cudaErrorInvalidValue;
  // x with its real C: channels of a box past C read as zero
  if ((im2col || boxed || padded) &&
      !cb::encode_im2col(&p.tma_a, a, 2 * box_c, pair_n ? wg::kBM / cb::kCluster : wg::kBM))
    return (int)cudaErrorInvalidValue;
  p.ksteps = (int)((2 * k + row - 1) / row);
  p.tiles_n = (a.O + bn - 1) / bn;
  const int tiles_m = (a.M + wg::kBM - 1) / wg::kBM;
  p.pairs = pair_n ? tiles_m * ((p.tiles_n + cb::kCluster - 1) / cb::kCluster)
                   : (tiles_m + cb::kCluster - 1) / cb::kCluster * p.tiles_n;
  if (route == cb::kRouteTma) return (int)cb::launch_bn<cb::kRouteTma>(p, bn, device, sms, s);
  if (boxed) {
    if (!cb::resident_layout(p, bn)) return (int)cudaErrorInvalidValue;
    return (int)cb::launch_boxed<cb::kRouteIm2col16>(p, bn, device, sms, s);
  }
  if (pair_n) return (int)cb::launch_one<cb::kRouteIm2colPad, cb::kPairBN>(p, device, sms, s);
  if (padded) return (int)cb::launch_bn<cb::kRouteIm2colPad>(p, bn, device, sms, s);
  if (route == cb::kRouteIm2col32)
    return (int)cb::launch_bn<cb::kRouteIm2col32>(p, bn, device, sms, s);
  if (route == cb::kRouteIm2col) return (int)cb::launch_bn<cb::kRouteIm2col>(p, bn, device, sms, s);
  return (int)cb::launch_bn<cb::kRouteGather>(p, bn, device, sms, s);
}
