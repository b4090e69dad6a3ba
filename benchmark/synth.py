"""Weights and frames made from the run's seed, on the run's device.

Weights: one folded fp32 (w, b) a conv, drawn in one ``randn`` call for all
weights and one for all biases, scaled by one float64 forward of the
reference (``make_weights``) under the constants below, then
rounded to bf16 and widened back, so that the bf16 program and the fp32
reference hold the same numbers.  He-scaled weights put a deep model's head
logits far out in the sigmoid's flat tails (every objectness 1.0, every score
tied); the scaling keeps activations near unit size through the depth, and
the head biases set how many anchors clear the confidence threshold and how
the classes are spread.

Frames: a pool of uint8 BGR batches, smooth like camera frames (a coarse
random image resized up, plus fine noise), so that neighbouring anchors see
alike features and fire together, as on real scenes, and NMS has overlapping
boxes of one class to suppress.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .reference.darknet import Darknet, conv_layers, letterbox, walk

# The weight init (``make_weights``): the root mean square of a body conv's
# output that feeds a [shortcut], the deviation of each anchor's two
# box-size logits, the biases' deviation, the class logits' offsets, and the
# frames of the seed the convs are scaled on.  A configuration sets only its
# head's objectness offset, ``obj_bias``: how many anchors clear ``conf``.
RESIDUAL = 0.5
BOX_SIZE_STD = 0.5
BIAS_STD = 0.1
CLASS_BIAS = {0: 4.0, 2: 3.0}
CALIB_FRAMES = 4
# The frame pool: batches used in turn, each a coarse uniform image 1/COARSE
# of the frame's size resized up, plus N(0, NOISE) a pixel.
POOL_BATCHES = 2
COARSE = 16
NOISE = 8.0


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream (weights 0, frames 1, the
    calibration frame 2) of a seed; any seed in [0, 2**61)."""
    if not 0 <= seed < 2 ** 61:
        raise ValueError(f"seed {seed} outside [0, 2**61)")
    return torch.Generator(device=device).manual_seed(4 * seed + stream)


def make_weights(cfg_text: str, obj_bias: float, seed: int, frames: torch.Tensor, size: int):
    """-> (weights {conv index: (w (O, C, k, k), b (O,))}, flat w, flat b),
    fp32 on ``frames``' device; the dict's tensors are views of the flat ones.

    All weights come from one ``randn`` call and all biases from another,
    N(0, BIAS_STD), with the head convs' objectness (``obj_bias``) and class
    (``CLASS_BIAS``) offsets added.
    Then one float64 forward of the reference at ``size`` over ``frames``
    (n, H, W, 3) uint8 scales each conv as it goes: a body conv's output to
    the root mean square 1 (``RESIDUAL`` where a [shortcut] adds it), and each
    output channel of a head conv to the mean 0 and the standard deviation 1
    over the frames (``BOX_SIZE_STD`` for each anchor's two box-size
    channels), the mean taken out of its bias, so that the head biases set
    the logits' centres.  Every weight is then rounded to bf16.  (Scaling
    every channel of every conv alike, as a folded batch norm does, makes a
    random net chaotic: bf16's rounding then moves the head logits by 15 %
    of their spread, against 2-3 % with the body scaled as a whole.)"""
    device = frames.device
    _, layers = walk(cfg_text)
    convs = conv_layers(layers)
    numels, bias_off, target = [], [], {}
    for conv in convs:
        o, c = conv.out_shape[0], conv.in_shape[0]
        k = int(conv.opts.get("size", 1))
        numels.append(o * c * k * k)
        nxt = layers[conv.index + 1].kind if conv.index + 1 < len(layers) else None
        std = [RESIDUAL if nxt == "shortcut" else 1.0] * o
        off = [0.0] * o
        if nxt == "yolo":
            attrs = 5 + int(layers[conv.index + 1].opts["classes"])
            for a in range(o // attrs):
                std[a * attrs + 2] = std[a * attrs + 3] = BOX_SIZE_STD
                off[a * attrs + 4] = float(obj_bias)
                for cls, value in CLASS_BIAS.items():
                    off[a * attrs + 5 + cls] = value
        bias_off.extend(off)
        target[conv.index] = (torch.tensor(std, dtype=torch.float64, device=device)
                              if nxt == "yolo" else torch.tensor(std[0], dtype=torch.float64,
                                                                  device=device))
    g = generator(device, seed, 0)
    flat_w = torch.randn(sum(numels), generator=g, device=device)
    offsets = torch.tensor(bias_off, dtype=torch.float32, device=device)
    flat_b = torch.randn(offsets.shape[0], generator=g, device=device) * BIAS_STD
    flat_b += offsets
    weights, wo, bo = {}, 0, 0
    for conv, n in zip(convs, numels):
        o, c = conv.out_shape[0], conv.in_shape[0]
        k = int(conv.opts.get("size", 1))
        weights[conv.index] = (flat_w[wo:wo + n].view(o, c, k, k), flat_b[bo:bo + o])
        wo, bo = wo + n, bo + o

    heads = {layer.index - 1 for layer in layers if layer.kind == "yolo"}

    def calibrate(index, x, w, b, stride, pad):
        y = F.conv2d(x, w.double(), None, stride=stride, padding=pad)
        if index in heads:  # each channel to mean 0 and its target deviation
            mean = y.mean(dim=(0, 2, 3))
            scale = target[index] / y.std(dim=(0, 2, 3)).clamp(min=1e-12)
            b.sub_((mean * scale).float())
        else:  # the whole output to the root mean square ``target``
            scale = target[index] / y.square().mean().sqrt()
        w.mul_(scale.float().expand(w.shape[0])[:, None, None, None])
        return y * scale.expand(w.shape[0])[:, None, None] + b.double()[:, None, None]

    x, _ = letterbox(frames, size)
    with torch.no_grad():
        Darknet(cfg_text, weights, size).forward(x.double(), conv=calibrate)
    flat_w.copy_(flat_w.to(torch.bfloat16))
    return weights, flat_w, flat_b


def host_params(weights: dict, flat_w: torch.Tensor, flat_b: torch.Tensor) -> dict:
    """The same weights as the program takes them: {index: {"w": OIHW, "b"}}
    numpy fp32 views of one host copy of each flat tensor."""
    hw, hb = flat_w.cpu().numpy(), flat_b.cpu().numpy()
    out, wo, bo = {}, 0, 0
    for index, (w, b) in weights.items():
        out[index] = {"w": hw[wo:wo + w.numel()].reshape(tuple(w.shape)),
                      "b": hb[bo:bo + b.numel()]}
        wo, bo = wo + w.numel(), bo + b.numel()
    return out


def make_frames(batch: int, frame_h: int, frame_w: int, seed: int, device: torch.device,
                pool: int = POOL_BATCHES, stream: int = 1) -> torch.Tensor:
    """(pool, batch, H, W, 3) uint8 BGR frames: a coarse uniform image
    (H / COARSE x W / COARSE) resized up bilinearly, plus N(0, NOISE) per
    pixel, rounded and clamped."""
    h, w = int(frame_h), int(frame_w)
    g = generator(device, seed, stream)
    frames = torch.empty((pool, batch, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(pool):  # one batch at a time bounds the fp32 temporaries
        low = torch.rand((batch, 3, h // COARSE, w // COARSE), generator=g, device=device) * 255.0
        img = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
        img += torch.randn((batch, 3, h, w), generator=g, device=device) * NOISE
        frames[i] = img.round_().clamp_(0.0, 255.0).to(torch.uint8).permute(0, 2, 3, 1)
    return frames


def calib_frames(traffic: dict, seed: int, device: torch.device) -> torch.Tensor:
    """(CALIB_FRAMES, H, W, 3): the frames of the seed the convs are scaled on."""
    return make_frames(CALIB_FRAMES, traffic["frame_h"], traffic["frame_w"], seed, device,
                       pool=1, stream=2)[0]


def pool_frames(traffic: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The cell's frame pool: (POOL_BATCHES, batch, H, W, 3)."""
    return make_frames(int(traffic["batch"]), traffic["frame_h"], traffic["frame_w"], seed,
                       device)
