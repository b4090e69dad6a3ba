"""Operations, bytes and the chip's peaks: the yardstick of the roofline and
MFU metrics, worked out from the frozen cfg, never from the program.

A conv's work is 2 * MACs, MACs = N * Ho * Wo * O * KH * KW * C (Darknet's
own BFLOPS count: 65.864 GFLOP an image for yolov3 at 416).  Its bytes count
each byte it must move once: the input map, the weights and the fp32 bias,
the output map and, where the conv feeds a [shortcut] that only it feeds,
the shortcut's other operand (the program adds it in the conv's epilogue).
Its bound is max(ops / peak ops, bytes / peak bytes) at the conv's precision.
"""

from __future__ import annotations

from typing import NamedTuple

from .reference.darknet import walk

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at 700 W
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": {
        "bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
        "tf32": 495e12, "fp32": 67e12}},
}
# element sizes of a conv's maps and weights at each precision
_ELEM_BYTES = {"bf16": 2, "fp16": 2, "fp8": 1, "int8": 1, "tf32": 4, "fp32": 4}


class ConvWork(NamedTuple):
    index: int
    flops: float   # 2 * MACs, the whole batch
    bytes: float   # each operand once, the whole batch


def conv_work(cfg_text: str, size: int, batch: int, precision: str) -> list[ConvWork]:
    """Each conv's operations and bytes at ``batch`` images of ``size``."""
    _, layers = walk(cfg_text, size)
    e = _ELEM_BYTES[precision]
    readers: dict[int, int] = {}
    for layer in layers:
        for j in layer.sources:
            readers[j] = readers.get(j, 0) + 1
    out = []
    for layer in layers:
        if layer.kind != "convolutional":
            continue
        (c, h, w), (o, ho, wo) = layer.in_shape, layer.out_shape
        k = int(layer.opts.get("size", 1))
        macs = batch * ho * wo * o * k * k * c
        nbytes = batch * h * w * c * e + o * k * k * c * e + o * 4 + batch * ho * wo * o * e
        nxt = layers[layer.index + 1] if layer.index + 1 < len(layers) else None
        if (nxt is not None and nxt.kind == "shortcut" and readers.get(layer.index) == 1
                and nxt.sources[1] != layer.index):
            nbytes += batch * ho * wo * o * e
        out.append(ConvWork(layer.index, 2.0 * macs, float(nbytes)))
    return out


def peaks(card: str) -> dict:
    """The card's peaks; a card without an entry has none (its roofline and
    MFU metrics are then not reported)."""
    return PEAKS.get(card, {})


def conv_bound_s(work: list[ConvWork], card: str, precision: str) -> "float | None":
    """Sum over the convs of max(ops / peak, bytes / bandwidth), seconds."""
    p = peaks(card)
    if not p:
        return None
    return sum(max(cw.flops / p["ops_per_s"][precision], cw.bytes / p["bytes_per_s"])
               for cw in work)


def flops(work: list[ConvWork]) -> float:
    return sum(cw.flops for cw in work)
