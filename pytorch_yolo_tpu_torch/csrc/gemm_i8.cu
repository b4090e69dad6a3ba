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
// What bounds it on an H100, and the design: see int8_igemm.cuh.  At the
// probe's shapes ((4096, 1024) x (1024, 512): 4.3 G ops over ~7 MB) and at
// yolov3's 1x1 convs at batch 128 (52x52x256 -> 128: 22.7 G ops over
// ~133 MB, ~170 ops per byte) the int8 tensor-core rate is the ceiling for
// the first and HBM bandwidth comes close to bounding the second; this
// first version reaches neither.

#include "int8_igemm.cuh"

// `args` points to an IgemmArgs (ops/kernels.py: _IgemmArgs).
extern "C" int yolo_int8_gemm(const void* args, int vec, int device, void* stream) {
  return launch_igemm<false>(static_cast<const IgemmArgs*>(args), vec, device, stream);
}
