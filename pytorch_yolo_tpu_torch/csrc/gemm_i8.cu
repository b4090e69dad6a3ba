// K3: int8 GEMM, s8 x s8 -> s32 on the tensor cores, with a fused epilogue.
//
// Replaces the Pallas TPU kernel tools/int8_kernel_probe.py: gemm_i8_pallas
// (body _gemm_i8_kernel): (M, K) int8 x (K, N) int8 -> (M, N) int8 through
// the fixed-point requant clip(acc > 0 ? ((acc >> pre) * m) >> sh
// : ((acc >> pre) * m) >> (sh + 3), +-127).  That epilogue is one mode
// here.  The same core with the dequant epilogue of
// pytorch_yolo_tpu/ops/quant.py: quantized_conv runs every quantized 1x1
// stride-1 conv of the int8 serving path: the NHWC input is an (M, K)
// matrix with M = N*H*W and K = C, and the (O, 1, 1, C) kernel is (N, K).
// The weight operand is taken transposed, (N, K), K contiguous: the
// "col" layout the tensor cores read.
//
// What bounds it on an H100: at the probe's shapes ((4096, 1024) x
// (1024, 512): 4.3 G ops over ~7 MB) the int8 tensor-core rate; at yolov3's
// 1x1 convs at batch 128 (52x52x256 -> 128, fp32 out: 22.7 G ops over
// 266 MB) HBM bandwidth, 0.079 ms at 3.35 TB/s.  The design: int8_wgmma.cuh
// (TMA for both operands, wgmma, a persistent schedule whose epilogue
// overlaps the next tile's loads, 16-byte staged stores).  The mma.sync
// core of int8_igemm.cuh keeps K not a multiple of 16.

#include "int8_igemm.cuh"
#include "int8_wgmma.cuh"

// `args` points to an IgemmArgs (ops/kernels.py: _IgemmArgs).  The wgmma
// core with a `bn`-column tile (128 or 256).
extern "C" int yolo_int8_gemm(const void* args, int bn, int device, void* stream) {
  return wg::launch_wgmma<false>(static_cast<const IgemmArgs*>(args), bn, device, stream);
}

// The mma.sync core; `vec` = K and the group offsets are multiples of 16.
extern "C" int yolo_int8_gemm_mma(const void* args, int vec, int device, void* stream) {
  return launch_igemm<false>(static_cast<const IgemmArgs*>(args), vec, device, stream);
}
