"""K5's plain version (``ops.kernels.conv_bf16_ref``) against the JAX
``_conv`` in bf16, the bf16 forward against the JAX bf16 forward, and K2's
plain version past the shared-memory K against JAX's fixpoint.

The JAX ``_conv`` (``pytorch_yolo_tpu/models/darknet.py:82-98``) sums the
bf16 operands in fp32, adds the fp32 bias, applies the activation in fp32
and rounds to bf16 once; the port's K5 and its plain version do the same.
The two fp32 sums are taken in different orders (XLA's and oneDNN's), so a
bf16 output may differ where its sum straddles a rounding boundary: the
gate is >= 99.9 % of outputs bit-equal and the rest within 1 bf16 ulp (the
distance between neighbouring bf16 values), except where the bias cancels
the sum: there an output far below the scale of its terms may differ by
more of its own steps, and the gate is the order error of an fp32 sum,
2^-20 of sum |x w| + |b| (``tests/test_torch_cuda.py: conv_bf16_floor``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.models.zoo import _GENERATORS
from pytorch_yolo_tpu.ops import nms as jnms
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import nms as tnms
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_cuda import (BOX_CONV_CASES, CONV_BF16_CASES, bf16_agreement,
                                   conv_bf16_floor, conv_bf16_input, nms_input)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jax_conv(x, w, b, stride, pad, act, shortcut=None):
    """The JAX ``_conv`` in bf16 on NHWC ``x`` and (O, KH, KW, C) ``w``
    (the bf16 values as fp32 arrays), then the shortcut as JAX adds it."""
    o, k = w.shape[0], w.shape[1]
    spec = jcfg.ConvSpec(index=0, in_channels=x.shape[-1], filters=o, size=k, stride=stride,
                         pad=int(pad > 0), batch_normalize=False, activation=act)
    assert spec.padding == pad
    y = jdn._conv(jnp.asarray(x), jnp.asarray(w.transpose(1, 2, 3, 0)), jnp.asarray(b), spec,
                  jnp.bfloat16, jax.lax.Precision.HIGHEST)
    if shortcut is not None:
        y = y + jnp.asarray(shortcut).astype(jnp.bfloat16)
    assert y.dtype == jnp.bfloat16
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("name", list(CONV_BF16_CASES) + list(BOX_CONV_CASES))
def test_conv_bf16_plain_matches_jax_conv(name):
    x, w, b, stride, pad, act, sc = conv_bf16_input(name)
    if name in BOX_CONV_CASES:  # the packed and "im2col16" routes' shapes
        assert tk.conv_bf16_plan(x.shape[-1], w.shape[0], w.shape[1], w.shape[2], stride,
                                 pad)[0] == BOX_CONV_CASES[name][0]
    ours = tk.conv_bf16(x, w, b, stride, pad, act, sc)  # CPU: the plain version
    assert ours.dtype == torch.bfloat16 and ours.is_contiguous()
    ref = _jax_conv(x.float().numpy(), w.float().numpy(), b.numpy(), stride, pad, act,
                    None if sc is None else sc.float().numpy())
    assert tuple(ours.shape) == ref.shape
    equal, ulps = bf16_agreement(ours, torch.from_numpy(ref.copy()),
                                 conv_bf16_floor(x, w, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (name, equal, ulps)


def test_conv_bf16_old_math_misses_jax():
    """What the repair is for: cuDNN's order on the CPU (bf16 conv output,
    then the bias in bf16, then leaky in bf16) is not JAX's, on the layer of
    the bf16 fault's measurement; K5's order is."""
    x, w, b, stride, pad, act, _ = conv_bf16_input("3x3 s1 26² 128->256 leaky")
    ref = torch.from_numpy(_jax_conv(x.float().numpy(), w.float().numpy(), b.numpy(), stride,
                                     pad, act))
    old = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), stride=stride,
                                     padding=pad)
    old = tdn.apply_activation(old + b.to(torch.bfloat16)[:, None, None], act).permute(0, 2, 3, 1)
    new = tk.conv_bf16(x, w, b, stride, pad, act)
    assert bf16_agreement(old, ref)[0] < 0.9 < 0.999 <= bf16_agreement(new, ref)[0]


def test_conv_bf16_checks_its_arguments():
    x, w, b, stride, pad, act, _ = conv_bf16_input("1x1 26² 128->64 leaky")
    with pytest.raises(ValueError, match="float32"):
        tk.conv_bf16(x, w, b.to(torch.bfloat16), stride, pad, act)
    with pytest.raises(ValueError, match="activation"):
        tk.conv_bf16(x, w, b, stride, pad, "swish")
    with pytest.raises(ValueError, match="shortcut"):
        tk.conv_bf16(x, w, b, stride, pad, act, shortcut=x)
    with pytest.raises(ValueError, match="expected"):
        tk.conv_bf16(x, w[..., :8], b, stride, pad, act)


@pytest.mark.parametrize("shape,want", [
    ((3, 32, 3, 3, 1, 1), ("packed", 32, 3)),      # the RGB stem: K = 27 in one 32-wide stage
    ((3, 40, 3, 3, 1, 1), ("packed", 48, 3)),      # yolov4x-mish's and p7's stem: 48 columns
    ((3, 64, 3, 3, 1, 1), ("packed", 64, 3)),      # up to 64 outputs, no padded copy of x
    ((3, 80, 3, 3, 1, 1), ("im2col16", 80, 8)),    # past 64: C padded to 8, one box a tap
    ((12, 128, 3, 3, 1, 1), ("im2col16", 128, 16)),  # the s2d stem's packed conv: K = 108
    ((512, 1024, 3, 3, 1, 1), ("im2col", 128, 512)),  # C % 64 == 0: A by TMA im2col
    ((256, 128, 1, 1, 1, 0), ("tma", 128, 256)),   # 1x1 stride 1: A by TMA
    ((128, 256, 3, 3, 2, 1), ("im2col", 128, 128)),  # stride 2 too
    ((1024, 255, 1, 1, 1, 0), ("tma", 128, 1024)),  # a yolov3 head
    ((32, 64, 3, 3, 1, 1), ("im2col32", 64, 32)),  # C = 32: one tap a 64-byte stage
    ((32, 64, 3, 3, 2, 1), ("im2col32", 64, 32)),
    ((32, 32, 3, 3, 1, 1), ("im2col32", 64, 32)),  # p5's and p6's conv 2
    ((160, 160, 3, 3, 1, 1), ("im2col_pad", 80, 160)),  # 3 boxes of 64 a tap, the last half
    ((160, 320, 3, 3, 2, 1), ("im2col_pad", 80, 160)),  # past C; O % 160 == 0: the cluster
    ((480, 480, 3, 3, 1, 1), ("im2col_pad", 80, 480)),  # on one M-tile, 80-column tiles
    ((160, 64, 3, 3, 1, 1), ("im2col_pad", 64, 160)),
    ((160, 96, 1, 1, 2, 0), ("im2col_pad", 128, 160)),  # a 1x1 stride-2 conv: one tap
    ((224, 240, 3, 3, 1, 1), ("im2col_pad", 128, 224)),  # 240: no multiple of 160
    ((24, 32, 3, 3, 1, 1), ("halo", 32, 24)),      # C % 16 == 8: the halo route
    ((24, 32, 1, 1, 2, 0), ("im2col16", 32, 24)),  # a 1x1 stride-2 conv: boxes
    ((16, 32, 3, 3, 1, 1), ("im2col16", 32, 16)),  # yolov2-tiny's conv 2: one box a tap
    ((40, 40, 3, 3, 1, 1), ("halo", 48, 40)),      # p7's conv 6: C % 16 == 8, <= 48 outputs
    ((40, 40, 3, 3, 2, 1), ("im2col16", 48, 40)),  # the halo route is stride 1 only
    ((40, 48, 3, 3, 1, 1), ("halo", 48, 40)),
    ((40, 56, 3, 3, 1, 1), ("im2col16", 64, 40)),  # past 48 outputs: 3 boxes a tap
    ((40, 96, 3, 3, 1, 1), ("im2col16", 48, 40)),  # two 48-column tiles, on the boxes
    ((40, 80, 3, 3, 1, 1), ("im2col16", 80, 40)),
    ((40, 80, 3, 3, 2, 1), ("im2col16", 80, 40)),
    ((80, 80, 3, 3, 1, 1), ("im2col16", 80, 80)),  # 5 boxes a tap
    ((80, 160, 3, 3, 2, 1), ("im2col16", 80, 80)),  # two 80-column tiles
    ((64, 128, 3, 3, 2, 1), ("im2col", 128, 64)),
    ((64, 128, 3, 3, 1, 1), ("im2col", 128, 64)),
    ((96, 128, 3, 3, 1, 1), ("im2col32", 128, 96)),  # C = 96: no gain measured (PERF.md)
    ((96, 160, 3, 3, 1, 1), ("im2col32", 128, 96)),
    ((3616, 64, 3, 3, 1, 1), ("gather", 64, 3616)),  # 513 boxes of 64: past the table
    ((88, 80, 3, 3, 1, 1), ("gather", 128, 88)),   # W (14 K chunks x 80 rows) too large to
    ((120, 64, 3, 3, 1, 1), ("gather", 64, 120)),  # stay beside 4 stages of boxes
    ((1000, 64, 3, 3, 1, 1), ("gather", 64, 1000)),  # 567 boxes: more than the table holds
    ((4096, 256, 3, 3, 1, 1), ("gather", 128, 4096)),  # 576 stages, 2304 boxes
])
def test_conv_bf16_plan(shape, want):
    assert tk.conv_bf16_plan(*shape) == want


def _tma_im2col_box(x, args, start, stage, width, rows=tk.CONV_BF16_TILE_M):
    """numpy model of one ``cp.async.bulk.tensor.4d...im2col`` box as the
    PTX ISA defines the im2col mode, over NHWC ``x``: ``rows`` pixels of
    ``width`` channels from ``c0``, walked from the start pixel (n, h, w) in
    W, then H, then N order at the conv's stride (the map's element
    strides) inside the box ``lower .. size - 1 + upper`` of the kernel's
    arguments; each read at (w + off_w, h + off_h), zero where that falls
    outside x, and zero in the channels past x's last (TMA's out-of-bounds
    fill, which the "im2col16" route's last box of a tap meets)."""
    nb, hh, ww, c = x.shape
    n, h, w = start
    c0, off_w, off_h = stage
    box = np.zeros((rows, width), x.dtype)
    for r in range(rows):
        ih, iw = h + off_h, w + off_w
        if n < nb and 0 <= ih < hh and 0 <= iw < ww:
            v = x[n, ih, iw, c0:c0 + width]
            box[r, :len(v)] = v
        w += args.stride
        if w > ww - 1 + args.hi_w:
            w, h = args.lo_w, h + args.stride
            if h > hh - 1 + args.hi_h:
                h, n = args.lo_h, n + 1
    return box


def _tile_start(args, m0):
    """The first pixel ``(n, h, w)`` of the box of the block tile whose first
    output row is ``m0``: output pixel m0's window's top-left corner, the
    lower corner plus (oh, ow) times the stride (the kernel's producer works
    this out per tile; the card's cases hold its copy)."""
    n, rem = divmod(m0, args.Ho * args.Wo)
    oh, ow = divmod(rem, args.Wo)
    return n, args.lo_h + oh * args.stride, args.lo_w + ow * args.stride


def _im2col(x, k, stride, pad):
    """(M, k * k * C) explicit im2col of NHWC ``x``, K in (tap, channel) order."""
    nb, hh, ww, c = x.shape
    ho, wo = (hh + 2 * pad - k) // stride + 1, (ww + 2 * pad - k) // stride + 1
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    cols = [xp[:, r:r + stride * (ho - 1) + 1:stride, q:q + stride * (wo - 1) + 1:stride]
            .reshape(nb * ho * wo, c) for r in range(k) for q in range(k)]
    return np.concatenate(cols, 1), ho, wo


@pytest.mark.parametrize("n,h,w,c,stride", [
    (1, 20, 20, 64, 1),   # 3x3 s1 pad 1; M = 400: M % 128 != 0
    (1, 13, 13, 128, 2),  # 3x3 s2 on an odd input: 13² -> 7²
    (2, 13, 13, 512, 1),  # tile 1 spans the two images
    (3, 9, 14, 64, 2),    # H != W, stride 2 across three images
    (2, 12, 7, 128, 1),
    (1, 20, 20, 32, 2),   # C = 32: one tap a stage of 32 channels
])
def test_conv_bf16_im2col_plan_walks_the_im2col(n, h, w, c, stride):
    """K5's im2col routes: the boxes that the TMA unit loads from the kernel's
    arguments as the wrapper builds them (the box corners and the stage
    table of (first channel, tap) entries) are the rows of the conv's
    explicit im2col, tile by tile and stage by stage, with zeros for
    padding and for rows past M."""
    k, pad = 3, 1
    route = tk.conv_bf16_plan(c, 256, k, k, stride, pad)[0]
    assert route == ("im2col" if c % 64 == 0 else "im2col32")
    x = np.random.default_rng(c + h).integers(1, 100, (n, h, w, c)).astype(np.float32)
    a, ho, wo = _im2col(x, k, stride, pad)
    m = a.shape[0]
    tiles = -(-m // tk.CONV_BF16_TILE_M)
    a = np.concatenate([a, np.zeros((tiles * tk.CONV_BF16_TILE_M - m, a.shape[1]),
                                    np.float32)])
    args = tk._conv_bf16_args((n, h, w, c), (256, k, k, c), stride, pad, "leaky", route)
    assert (args.M, args.Ho, args.Wo, args.C) == (m, ho, wo, c)
    width = 64 if route == "im2col" else 32
    ksteps = k * k * c // width
    assert args.stages == ksteps and not any(args.stage_tab[ksteps:])
    stages = [(e & 0xFFFF, e >> 16 & 0xFF, e >> 24) for e in args.stage_tab[:ksteps]]
    assert tk.conv_bf16_traffic((n, h, w, c), (256, k, k, c), stride, pad)[:2] == (
        -(-tiles // 2) * 4, ksteps)  # pairs of M-tiles, two N-tiles of 128
    for t in range(tiles):
        m0 = t * tk.CONV_BF16_TILE_M
        start = _tile_start(args, m0)
        for s in range(ksteps):
            box = _tma_im2col_box(x, args, start, stages[s], width)
            want = a[m0:m0 + tk.CONV_BF16_TILE_M, s * width:(s + 1) * width]
            np.testing.assert_array_equal(box, want, err_msg=f"tile {t}, stage {s}")
    if tiles % 2:  # a cluster's second M-tile past M reads zeros
        start = _tile_start(args, tiles * tk.CONV_BF16_TILE_M)
        assert not _tma_im2col_box(x, args, start, stages[0], width).any()


@pytest.mark.parametrize("n,h,w,c,o,stride", [
    (1, 17, 17, 40, 80, 1),   # 289 pixels: 3 M-tiles, the cluster's fourth past M
    (2, 13, 13, 80, 160, 1),  # tiles across the two images, two 80-column tiles
    (1, 20, 20, 40, 80, 2),   # stride 2, 3 boxes a tap (the third half past C)
    (1, 12, 12, 16, 32, 1),   # one box a tap: 9 boxes, the last stage holds one
    (3, 9, 14, 24, 56, 2),    # H != W across three images, 2 boxes a tap, 48-column tiles
])
def test_conv_bf16_im2col16_boxes_walk_the_conv(n, h, w, c, o, stride):
    """K5's "im2col16" route: the boxes of 16 channels of one tap that the
    TMA unit loads from the kernel's arguments (the corners and the stage
    table, ``CONV_BF16_BOXES`` boxes a stage, the last stage holding the
    rest), each against its 16 of K of W in box order
    (``conv_bf16_weights``: zero channels past C), give the flat conv's
    sums tile by tile; channels past C read as zeros and rows past M give
    zero sums.  The traffic model counts the same tiles and stages."""
    k, pad = 3, 1
    route, bn, cp = tk.conv_bf16_plan(c, o, k, k, stride, pad)
    assert route == "im2col16" and cp == c
    rng = np.random.default_rng(c + h)
    x = rng.integers(-8, 9, (n, h, w, c)).astype(np.float32)
    wt = rng.integers(-4, 5, (o, k, k, c)).astype(np.float32)
    a, ho, wo = _im2col(x, k, stride, pad)
    m = a.shape[0]
    want = a @ wt.reshape(o, -1).T  # the flat conv, exact on small integers
    args = tk._conv_bf16_args((n, h, w, c), (o, k, k, c), stride, pad, "linear", route)
    assert (args.M, args.Ho, args.Wo, args.C) == (m, ho, wo, c)
    boxes = k * k * -(-c // 16)
    assert args.stages == boxes and not any(args.stage_tab[boxes:])
    entries = [(e & 0xFFFF, e >> 16 & 0xFF, e >> 24) for e in args.stage_tab[:boxes]]
    wb = tk.conv_bf16_weights(torch.from_numpy(wt), route, cp).numpy().reshape(o, -1)
    assert wb.shape[1] == boxes * 16
    past = [j for j, (c0, _, _) in enumerate(entries) if c0 + 16 > c]
    assert len(past) == (k * k if c % 16 else 0)
    for j in past:  # W's channels of a box past C are zero
        assert not wb[:, 16 * j + c - entries[j][0]:16 * (j + 1)].any()
    ksteps = -(-boxes // tk.CONV_BF16_BOXES)
    tiles = -(-m // tk.CONV_BF16_TILE_M)
    assert tk.conv_bf16_traffic((n, h, w, c), (o, k, k, c), stride, pad)[:2] == (
        -(-tiles // 2) * 2 * -(-o // bn), ksteps)
    for t in range(-(-tiles // 2) * 2):
        m0 = t * tk.CONV_BF16_TILE_M
        start = _tile_start(args, m0)
        sums = np.zeros((tk.CONV_BF16_TILE_M, o), np.float32)
        for s in range(ksteps):
            js = range(s * tk.CONV_BF16_BOXES, min(boxes, (s + 1) * tk.CONV_BF16_BOXES))
            for j in js:
                box = _tma_im2col_box(x, args, start, entries[j], 16)
                if j in past:
                    assert not box[:, c - entries[j][0]:].any()
                sums += box @ wb[:, 16 * j:16 * (j + 1)].T
        rows = max(0, min(tk.CONV_BF16_TILE_M, m - m0))
        np.testing.assert_array_equal(sums[:rows], want[m0:m0 + rows], err_msg=f"tile {t}")
        assert not sums[rows:].any()


@pytest.mark.parametrize("n,h,w,c,o,stride,k", [
    (1, 17, 17, 160, 160, 1, 3),  # 289 pixels: 3 M-tiles; 3 boxes a tap, the last half past C
    (2, 13, 13, 160, 160, 2, 3),  # stride 2, tiles across the two images, 80-column tiles
    (3, 9, 14, 224, 240, 1, 3),   # H != W across three images, 4 boxes a tap
    (1, 12, 12, 480, 96, 1, 3),   # yolov4-p7's C = 480: 8 boxes a tap, 72 stages
    (1, 14, 14, 160, 96, 2, 1),   # a 1x1 stride-2 conv: one tap
])
def test_conv_bf16_pad_boxes_walk_the_conv(n, h, w, c, o, stride, k):
    """K5's "im2col_pad" route: the boxes of 64 channels of one tap that the
    TMA unit loads from the kernel's arguments (the corners and the stage
    table, one box a stage, ceil(C / 64) a tap), each against its 64 of K of
    W in box order (``conv_bf16_weights``: zero channels past C), give the
    flat conv's sums tile by tile; a tap's last box reads its channels
    past C as zeros, rows past M give zero sums, and the tile's two halves
    of 64 pixels, each walked from its own first pixel (the cluster on one
    M-tile, ``CONV_BF16_PAIR_BN``), are its box.  The traffic model counts
    the same tiles and stages."""
    pad = k // 2
    route, bn, cp = tk.conv_bf16_plan(c, o, k, k, stride, pad)
    assert route == "im2col_pad" and cp == c
    rng = np.random.default_rng(c + h)
    x = rng.integers(-8, 9, (n, h, w, c)).astype(np.float32)
    wt = rng.integers(-4, 5, (o, k, k, c)).astype(np.float32)
    a, ho, wo = _im2col(x, k, stride, pad)
    m = a.shape[0]
    want = a @ wt.reshape(o, -1).T  # the flat conv, exact on small integers
    args = tk._conv_bf16_args((n, h, w, c), (o, k, k, c), stride, pad, "linear", route)
    assert (args.M, args.Ho, args.Wo, args.C) == (m, ho, wo, c)
    boxes = k * k * -(-c // 64)
    assert args.stages == boxes and not any(args.stage_tab[boxes:])
    entries = [(e & 0xFFFF, e >> 16 & 0xFF, e >> 24) for e in args.stage_tab[:boxes]]
    wb = tk.conv_bf16_weights(torch.from_numpy(wt), route, cp).numpy().reshape(o, -1)
    assert wb.shape[1] == boxes * 64
    past = [j for j, (c0, _, _) in enumerate(entries) if c0 + 64 > c]
    assert len(past) == k * k
    for j in past:  # W's channels of a box past C are zero
        assert not wb[:, 64 * j + c - entries[j][0]:64 * (j + 1)].any()
    tiles = -(-m // tk.CONV_BF16_TILE_M)
    pair = bn == tk.CONV_BF16_PAIR_BN
    assert tk.conv_bf16_traffic((n, h, w, c), (o, k, k, c), stride, pad)[:2] == (
        tiles * 2 * -(-o // (2 * bn)) if pair else -(-tiles // 2) * 2 * -(-o // bn), boxes)
    half = tk.CONV_BF16_TILE_M // 2
    for t in range(-(-tiles // 2) * 2):
        m0 = t * tk.CONV_BF16_TILE_M
        start = _tile_start(args, m0)
        sums = np.zeros((tk.CONV_BF16_TILE_M, o), np.float32)
        for j, e in enumerate(entries):
            box = _tma_im2col_box(x, args, start, e, 64)
            halves = [_tma_im2col_box(x, args, _tile_start(args, m0 + r * half), e, 64, half)
                      for r in (0, 1)]
            np.testing.assert_array_equal(np.concatenate(halves), box)
            if j in past:
                assert not box[:, c - e[0]:].any()
            sums += box @ wb[:, 64 * j:64 * (j + 1)].T
        rows = max(0, min(tk.CONV_BF16_TILE_M, m - m0))
        np.testing.assert_array_equal(sums[:rows], want[m0:m0 + rows], err_msg=f"tile {t}")
        assert not sums[rows:].any()


@pytest.mark.parametrize("bn,ksteps,want", [
    (48, 7, 8),    # C = 40, 40 outputs: W 42 KB beside 8 stages of A
    (80, 7, 8),    # C = 40, 80 or 160 outputs
    (80, 12, 5),   # C = 80: W 120 KB beside 5 stages
    (80, 13, 4),   # C = 88, 80 outputs: the last W that fits beside 4
    (80, 14, 0),   # C = 96 boxes' W: the plan sends such a conv to the gather
    (128, 3, 8),   # the s2d stem's C = 12 (padded to 16)
    (128, 20, 0),  # W 320 KB
])
def test_conv_bf16_ring(bn, ksteps, want):
    """The "im2col16" ring beside W's resident N-tile, as the kernel's
    ``resident_layout`` sizes it: whatever fits of 8 A stages, at least 4."""
    assert tk.conv_bf16_ring(bn, ksteps) == want
    if want:  # the shared memory it leaves room for
        fixed = 2 * 64 * 160 + 2 * bn * 4 + 128 * 16 + 8 * (2 * want + 1) + 1024
        assert want * 16384 + ksteps * bn * 128 + fixed <= tk.CONV_BF16_SMEM


def _halo_box(x, plan, n, th, tw):
    """numpy model of the halo route's 4-D tiled TMA box: ``plan.hr`` rows
    of ``plan.hw`` pixels of ``plan.cp`` channels from input pixel
    (th * 4 - 1, tw * 32 - 1) of image n, zero outside x and past its C
    channels."""
    nb_, hh, ww, c = x.shape
    th_, tw_ = tk.CONV_BF16_HALO_TILE
    h0, w0 = th * th_ - 1, tw * tw_ - 1
    box = np.zeros((plan.hr, plan.hw, plan.cp), x.dtype)
    for i in range(plan.hr):
        for j in range(plan.hw):
            if 0 <= h0 + i < hh and 0 <= w0 + j < ww:
                box[i, j, :c] = x[n, h0 + i, w0 + j]
    return box


def _ldmatrix_a(flat, plan, j, cw, warp):
    """The 16 x 16 A block that a consumer warp's ldmatrix.x4 gives k16 step
    ``j`` (tap j // nb, channel block j % nb), read back through the
    m16n8k16 A fragment layout: lane L names row (L % 8) + 8 (L // 8 % 2)
    at channel half L // 16, as the kernel's lane offset does; thread t
    gets matrix i's row t // 4, columns 2 (t % 4) and + 1."""
    th_, tw_ = tk.CONV_BF16_HALO_TILE
    tap, blk = divmod(j, plan.nb)
    r, q = divmod(tap, 3)
    addr = []
    for lane in range(32):
        prow = 64 * cw + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)
        off = ((prow // tw_) * plan.hw + prow % tw_) * plan.cp + 8 * (lane >> 4)
        addr.append(off + (r * plan.hw + q) * plan.cp + 16 * blk)  # in elements
    a = np.zeros((16, 16), flat.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            src = addr[8 * i + g]  # matrix i's row g
            a[g + dr, 2 * t + dk:2 * t + dk + 2] = flat[src + 2 * t:src + 2 * t + 2]
    return a


@pytest.mark.parametrize("n,h,w,c,o", [
    (1, 9, 40, 40, 40),   # 9 x 40 -> tiles of 4 x 32 past the right and bottom edges
    (2, 8, 64, 80, 48),   # two images, C = 80 (5 blocks a tap)
    (1, 10, 70, 24, 32),  # C = 24, a 32-column tile
    (1, 5, 33, 16, 32),   # C = 16: one block a tap
])
def test_conv_bf16_halo_fragments_walk_the_conv(n, h, w, c, o):
    """K5's halo route: the halo box each block tile loads (numpy model of
    the tiled TMA box, zeros past x's edges and past C), read through the
    consumers' ldmatrix lane addresses and the wgmma A fragment layout,
    times W in box order (``conv_bf16_weights``), gives the flat conv's
    sums at every output pixel of the tile that lies inside the image; the
    geometry is the kernel's (``conv_bf16_halo``)."""
    k, stride, pad = 3, 1, 1
    bn = 32 if o <= 32 else 48
    plan = tk.conv_bf16_halo(c, bn)
    assert plan is not None and plan.cp >= 16 * plan.nb and plan.cp % 8 == 0
    # 8 neighbouring pixels' 16-byte rows in 8 bank groups
    assert len({(i * plan.cp * 2 // 16) % 8 for i in range(8)}) == 8
    rng = np.random.default_rng(c + w)
    x = rng.integers(-8, 9, (n, h, w, c)).astype(np.float32)
    wt = rng.integers(-4, 5, (o, k, k, c)).astype(np.float32)
    a, ho, wo = _im2col(x, k, stride, pad)
    want = (a @ wt.reshape(o, -1).T).reshape(n, ho, wo, o)
    wb = tk.conv_bf16_weights(torch.from_numpy(wt), "halo", c).numpy().reshape(o, -1)
    steps = 9 * plan.nb
    assert wb.shape[1] == 16 * steps and plan.ksteps == -(-steps // 4)
    th_, tw_ = tk.CONV_BF16_HALO_TILE
    for img in range(n):
        for th in range(-(-ho // th_)):
            for tw in range(-(-wo // tw_)):
                flat = _halo_box(x, plan, img, th, tw).reshape(-1)
                sums = np.zeros((128, o), np.float32)
                for cw in range(2):
                    for warp in range(4):
                        rows = slice(64 * cw + 16 * warp, 64 * cw + 16 * warp + 16)
                        for j in range(steps):
                            sums[rows] += _ldmatrix_a(flat, plan, j, cw, warp) @ \
                                wb[:, 16 * j:16 * (j + 1)].T
                for p_ in range(128):
                    oh, ow = th * th_ + p_ // tw_, tw * tw_ + p_ % tw_
                    if oh < ho and ow < wo:
                        np.testing.assert_array_equal(sums[p_], want[img, oh, ow])


def test_conv_bf16_weights_padded_once():
    """W as K5 reads it: zero channels up to the box width on "im2col16"
    (40 -> 48) and "im2col_pad" (160 -> 192: channels 160-191 of each tap
    zero), to the padded C elsewhere (12 -> 16), ``w`` itself where
    nothing is added; made once a weight tensor and width, again after the
    tensor is written to, and dropped with it."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 3, 3, 40))
                         .astype(np.float32)).to(torch.bfloat16)
    boxed = tk.conv_bf16_weights(w, "im2col16", 40)
    assert tuple(boxed.shape) == (8, 3, 3, 48) and boxed.is_contiguous()
    assert torch.equal(boxed[..., :40], w) and not boxed[..., 40:].any()
    assert tk.conv_bf16_weights(w, "im2col16", 40) is boxed
    assert tk.conv_bf16_weights(w, "gather", 40) is w
    assert tuple(tk.conv_bf16_weights(w[..., :12].contiguous(), "gather", 16).shape) == (
        8, 3, 3, 16)
    assert tk.conv_bf16_weights(w, "im2col_pad", 40) is not boxed  # 64 channels: another width
    w160 = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 3, 3, 160))
                            .astype(np.float32)).to(torch.bfloat16)
    pad = tk.conv_bf16_weights(w160, "im2col_pad", 160)
    assert tuple(pad.shape) == (4, 3, 3, 192) and pad.is_contiguous()
    assert torch.equal(pad[..., :160], w160) and not pad[..., 160:].any()
    assert tk.conv_bf16_weights(w160, "im2col32", 160) is w160
    w.mul_(2)
    again = tk.conv_bf16_weights(w, "im2col16", 40)
    assert again is not boxed and torch.equal(again[..., :40], w)
    key = (id(w), 48)
    assert key in tk._PADDED_W
    del w
    assert key not in tk._PADDED_W


SHORTCUT_CFG = """
[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=mish

[shortcut]
from=-2
activation=linear

[convolutional]
size=1
stride=1
pad=1
filters=24
activation=linear

[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=3
num=3
"""


@pytest.mark.parametrize("name,size,tol", [("yolov3-tiny", 160, 0.0045),
                                           ("shortcuts", 64, 0.0045)])
def test_bf16_forward_matches_jax_bf16(name, size, tol):
    """The whole bf16 forward (He seed 0, inputs from rng 2, 2 frames)
    against the JAX bf16 forward: each head's relative L2 error.  Before
    K5's order the port read 0.0061 / 0.0054 on yolov3-tiny @160.  The
    "shortcuts" model runs two [shortcut]s in K5's epilogue (one reads a
    conv output, one a shortcut output); the unfused run (a stats hook
    turns fusion off) gives the same heads bit for bit."""
    text = SHORTCUT_CFG if name == "shortcuts" else _GENERATORS[name]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    params = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec))
    x = np.random.default_rng(2).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    ref = jax.jit(jdn.build_forward(jspec, compute_dtype=jnp.bfloat16))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    model = tdn.Darknet(tspec, params_from_jax(params), dtype=torch.bfloat16, precision="default")
    assert all(c.bias.dtype == torch.float32 and c.weight.dtype == torch.bfloat16
               for c in model.convs.values())
    ours = model(torch.from_numpy(x))
    for o, r in zip(ours, ref):
        r = torch.from_numpy(np.asarray(r))
        assert o.dtype == r.dtype == torch.float32
        assert float((o - r).norm() / r.norm()) <= tol
    if name == "shortcuts":
        assert tdn._fused_shortcuts(tspec) == frozenset({3, 5})
        unfused, _ = model(torch.from_numpy(x), collect_conv_in_stats=lambda i, t: None)
        for o, u in zip(ours, unfused):
            assert torch.equal(o, u)


def test_nms_keep_plain_matches_jax_fixpoint_past_shared_k():
    """K2's plain version at K = 1500 (past the kernel's shared-memory 1024,
    the large-K mode on the card) against JAX's fixpoint_suppress, image by
    image, class-wise and class-agnostic."""
    boxes, valid, cls = nms_input(11, 2, 1500)
    for class_wise in (False, True):
        ours = tk.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45,
                           torch.from_numpy(cls) if class_wise else None).numpy()
        for i in range(2):
            iou = jnms.iou_matrix(jnp.asarray(boxes[i]))
            if class_wise:
                iou = jnp.where(jnp.abs(cls[i][:, None] - cls[i][None, :]) < 0.5, iou, 0.0)
            ref = np.asarray(jnms.fixpoint_suppress(iou, jnp.asarray(valid[i]), 0.45))
            np.testing.assert_array_equal(ours[i], ref)
            assert 0 < ref.sum() < valid[i].sum()
    assert tk.nms_scratch_words(2, 1500) == 2 * 47 * 32 * 47
    assert tk.nms_scratch_words(8, 1024) == 0


def test_batched_nms_serves_max_det_past_1024():
    """``max_det`` up to the candidate count D, as JAX's batched_nms_fused:
    K = min(max_det, D) = 2000 here; equal to the JAX pipeline's NMS on the
    same rows."""
    rng = np.random.default_rng(5)
    n, d = 2, 2535  # yolov3-tiny @416
    xy = rng.uniform(0, 380, (n, d, 2))
    wh = rng.uniform(8, 60, (n, d, 2))
    rows = np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, d, 2)),
                           rng.integers(0, 5, (n, d, 1)), np.zeros((n, d, 1))], -1)
    rows[..., 7] = rows[..., 4]
    rows = rows.astype(np.float32)
    ours = tnms.batched_nms_fused(torch.from_numpy(rows), 0.3, 0.45, max_det=2000)
    ref = jnms.batched_nms_fused(jnp.asarray(rows), 0.3, 0.45, max_det=2000, use_pallas=False)
    assert tuple(ours.valid.shape) == (n, 2000)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.boxes.numpy(), np.asarray(ref.boxes))
