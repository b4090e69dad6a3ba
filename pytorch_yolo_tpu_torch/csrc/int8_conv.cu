// K4: int8 implicit-GEMM convolution, NHWC int8 activations x (O, KH, KW, C)
// int8 weights -> int32 accumulators, with the fused epilogue of the int8
// serving path.
//
// Replaces XLA's int8 conv in pytorch_yolo_tpu/ops/quant.py: quantized_conv
// (_mxu, lax.conv_general_dilated(..., preferred_element_type=int32)) and
// the elementwise epilogue after it (dequant, bias, activation, optional
// requant to int8, per-branch accumulators of split-concat inputs).  It has
// no Pallas source: on the TPU XLA fused that epilogue into its conv, and
// PyTorch has no int8 convolution on CUDA.  Every quantized conv that is
// not 1x1 stride-1 (k x k kernels, stride 1 or 2, Darknet's size//2
// padding) runs here.
//
// The gather is implicit: output pixel m = (n, oh, ow) and tap (r, s) read
// input pixel (n, oh*stride - pad + r, ow*stride - pad + s), whose channels
// are contiguous in NHWC, so each 16-byte copy is one pixel's 16 channels;
// taps that fall in the padding are zero-filled by the copy itself.  What
// bounds it on an H100: the tensor cores at 13x13 (204 G ops over 104 MB at
// batch 128 for 512 -> 1024) and HBM at 52x52, where the fp32 output is
// most of the ~400 MB; both near 0.1 ms.  The design: int8_wgmma.cuh, whose
// producer warpgroup gathers A with cp.async while TMA brings the weights.
// The mma.sync core of int8_igemm.cuh keeps the byte path (C or a group
// width not a multiple of 16, such as the RGB stem).

#include "int8_igemm.cuh"
#include "int8_wgmma.cuh"

// `args` points to an IgemmArgs (ops/kernels.py: _IgemmArgs).  The wgmma
// core with a `bn`-column tile (128 or 256).
extern "C" int yolo_int8_conv(const void* args, int bn, int device, void* stream) {
  return wg::launch_wgmma<true>(static_cast<const IgemmArgs*>(args), bn, device, stream);
}

// The mma.sync core; `vec` = C and the group offsets are multiples of 16.
extern "C" int yolo_int8_conv_mma(const void* args, int vec, int device, void* stream) {
  return launch_igemm<true>(static_cast<const IgemmArgs*>(args), vec, device, stream);
}
