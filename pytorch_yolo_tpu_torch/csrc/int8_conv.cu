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
// bounds it on an H100 (the tensor cores at yolov3's widths; 65.86 G ops per
// yolov3@416 image against a 1,979 TOPS int8 peak) and the tiling: see
// int8_igemm.cuh.

#include "int8_igemm.cuh"

// `args` points to an IgemmArgs (ops/kernels.py: _IgemmArgs).
extern "C" int yolo_int8_conv(const void* args, int vec, int device, void* stream) {
  return launch_igemm<true>(static_cast<const IgemmArgs*>(args), vec, device, stream);
}
