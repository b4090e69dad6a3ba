"""The int8 RGB stem on K4's packed route, on the CPU.

The first int8 conv of every ladder family at early skip 0 is a 3x3 conv
of the 3-channel letterboxed image: yolov2 and yolov2-tiny at stride 1
(3 -> 32, 3 -> 16), yolov4-tiny at stride 2 (3 -> 32).  ``igemm_plan``
sends it to ``csrc/int8_packed.cu``, which builds a 32-byte row of A for
each output pixel (the 27 window values in W's (KH, KW, C) order, 5
zeros) from slices of the input rows that a tile reads.  The card's
kernel cannot run here, so:
  * the plan is checked on a table of shapes: the three zoo stems and the
    route's edges go to ``packed``, everything else keeps its core;
  * ``kernels.int8_packed_rows``, a numpy model of the producer's steps
    (the 16-byte copies of each slice into a slot of stale bytes, the
    words read and funnel-shifted, the padding masks), times W's 32 x 32
    tile gives the plain version's int32 sums exactly, tile by tile, at
    stride 1 and 2, on odd sizes, tiles crossing images and rows past M;
  * the shared memory the launcher asks for fits the card at every width;
  * the port's stem (K6, then ``int8_conv_ref``) equals JAX's
    ``quantized_conv`` bit for bit at 64 pixels, int8 and fp32 out.
Exact everywhere: the sums are integers, and the epilogue's multiply-adds
round once on both sides (``tests/test_torch_quant.py``).  Card tests:
``tests/test_torch_cuda.py`` (the ``conv3x3_rgb_stem_*`` cases).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu.ops import quant as jq
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import quant as tq
from tests.torch_threads import one_torch_thread  # noqa: F401


# (C, group offsets, O, split, aligned, KH, KW, stride, pad, shortcut) -> plan
PLAN_CASES = {
    "yolov2_stem_s1_3_32": ((3, [0, 3], 32, False, True, 3, 3, 1, 1, False), ("packed", 32)),
    "yolov2_tiny_stem_s1_3_16": ((3, [0, 3], 16, False, True, 3, 3, 1, 1, False), ("packed", 32)),
    "yolov4_tiny_stem_s2_3_32": ((3, [0, 3], 32, False, True, 3, 3, 2, 1, False), ("packed", 32)),
    "stem_o8": ((3, [0, 3], 8, False, True, 3, 3, 1, 1, False), ("packed", 32)),
    "stem_o24_s2": ((3, [0, 3], 24, False, True, 3, 3, 2, 1, False), ("packed", 32)),
    "stem_o40": ((3, [0, 3], 40, False, True, 3, 3, 1, 1, False), ("mma", 128)),
    "stem_o12": ((3, [0, 3], 12, False, True, 3, 3, 1, 1, False), ("mma", 128)),
    "c3_1x1": ((3, [0, 3], 16, False, True, 1, 1, 1, 0, False), ("mma", 128)),
    "c3_5x5": ((3, [0, 3], 16, False, True, 5, 5, 1, 2, False), ("mma", 128)),
    "c3_stride3": ((3, [0, 3], 16, False, True, 3, 3, 3, 1, False), ("mma", 128)),
    "c3_pad0": ((3, [0, 3], 16, False, True, 3, 3, 1, 0, False), ("mma", 128)),
    "c3_split_groups": ((3, [0, 1, 3], 16, True, True, 3, 3, 1, 1, False), ("mma", 128)),
    "c3_shortcut": ((3, [0, 3], 32, False, True, 3, 3, 1, 1, True), ("mma", 128)),
    "c3_unaligned": ((3, [0, 3], 32, False, False, 3, 3, 1, 1, False), ("mma", 128)),
    "c40_3x3": ((40, [0, 40], 32, False, True, 3, 3, 1, 1, False), ("mma", 128)),
    "c64_3x3": ((64, [0, 64], 32, False, True, 3, 3, 1, 1, False), ("wgmma", 128)),
    "split_256_1024": ((1280, [0, 256, 1280], 1024, True, True, 3, 3, 1, 1, False),
                       ("wgmma", 128)),
    "c512_o1024": ((512, [0, 512], 1024, False, True, 3, 3, 1, 1, False), ("wgmma", 256)),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_igemm_plan_sends_rgb_stems_to_packed(name):
    args, plan = PLAN_CASES[name]
    assert tk.igemm_plan(*args) == plan


# (N, H, W, stride, O): the zoo stems' widths at small sizes; odd sides,
# where a tile ends mid-row and the last one runs past M; stride 2 on odd
# sides (the last tap of a row past the image); tiles that cross small
# images; one-pixel-wide and one-pixel-high images; rows wider than a tile
MODEL_CASES = {
    "s1_2x17x19_o32": (2, 17, 19, 1, 32),
    "s1_1x33x31_o16": (1, 33, 31, 1, 16),
    "s2_3x9x7_o32": (3, 9, 7, 2, 32),
    "s2_1x35x33_o24": (1, 35, 33, 2, 24),
    "s2_2x16x16_o8": (2, 16, 16, 2, 8),
    "s1_9x7x5_tiles_cross_images": (9, 7, 5, 1, 16),
    "s1_5x1x1": (5, 1, 1, 1, 8),
    "s2_3x9x1_one_column": (3, 9, 1, 2, 16),
    "s1_2x1x9_one_row": (2, 1, 9, 1, 16),
    "s1_1x3x300_wide_rows": (1, 3, 300, 1, 32),
    "s2_1x5x611_wide_rows": (1, 5, 611, 2, 32),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_packed_rows_times_w_is_the_plain_sums(name):
    """Every tile of the model's A, times W's tile, equals the plain
    version's int32 sums; rows past M and bytes 27-31 of every row are
    zero, and W's rows past O are zero."""
    n, h, w, stride, o = MODEL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.integers(-127, 128, (n, h, w, 3)).astype(np.int8)
    wq = rng.integers(-127, 128, (o, 3, 3, 3)).astype(np.int8)
    acc = tk.int8_conv_ref(torch.from_numpy(x), torch.from_numpy(wq), stride, 1,
                           accumulators=True).numpy().reshape(-1, o)
    wt = tk.int8_packed_weights(wq)
    assert wt.shape == (tk.INT8_PACKED_N, tk.INT8_PACKED_K) and not wt[o:].any()
    assert not wt[:, 27:].any()
    m = acc.shape[0]
    for t in range(-(-m // tk.INT8_PACKED_ROWS)):
        rows = tk.int8_packed_rows(x, stride, t)
        assert rows.shape == (tk.INT8_PACKED_ROWS, tk.INT8_PACKED_K) and rows.dtype == np.int8
        live = min(tk.INT8_PACKED_ROWS, m - t * tk.INT8_PACKED_ROWS)
        sums = rows.astype(np.int64) @ wt.astype(np.int64).T
        np.testing.assert_array_equal(sums[:live, :o],
                                      acc[t * tk.INT8_PACKED_ROWS:t * tk.INT8_PACKED_ROWS + live])
        assert not rows[live:].any() and not rows[:, 27:].any()


def test_packed_rows_are_the_windows():
    """Row i of a tile holds pixel i's 3x3x3 window in (KH, KW, C) order,
    zero where a tap falls in the padding: read off a padded copy of x
    (values 1..127, so that no real tap is zero)."""
    rng = np.random.default_rng(7)
    for stride in (1, 2):
        x = rng.integers(1, 128, (2, 11, 13, 3)).astype(np.int8)
        xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        ho, wo = (11 - 1) // stride + 1, (13 - 1) // stride + 1
        want = np.stack([xp[b, oh * stride:oh * stride + 3, ow * stride:ow * stride + 3].reshape(27)
                         for b in range(2) for oh in range(ho) for ow in range(wo)])
        got = np.concatenate([tk.int8_packed_rows(x, stride, t)
                              for t in range(-(-len(want) // tk.INT8_PACKED_ROWS))])
        np.testing.assert_array_equal(got[:len(want), :27], want)


def test_packed_slices_cover_every_tile():
    """The launcher's slice geometry (``int8_packed_slot``,
    ``int8_packed_max_segments``) against a brute force: the most output
    rows a tile of 256 pixels touches from any first column, and the largest input
    span a segment reads with its copies' alignment, at every width up to
    600 and a few wider, stride 1 and 2; the shared memory fits the card's
    227 KB at every width."""
    rows = tk.INT8_PACKED_ROWS
    for wo in [*range(1, 601), 1023, 4096, 8191]:
        touched = {ow0: (ow0 + rows - 1) // wo + 1 for ow0 in range(wo)}
        assert tk.int8_packed_max_segments(wo) == max(touched.values()), wo
        for stride in (1, 2):
            span = ((min(wo, rows) - 1) * stride + 3) * 3  # bytes of the widest segment's span
            slot = tk.int8_packed_slot(wo, stride)
            assert slot % 16 == 0 and slot >= 15 + span + 15 + 1, (wo, stride)
            assert tk.int8_packed_smem(wo, stride) <= tk._SMEM_LIMIT, (wo, stride)


def test_fast_divisor_divides_exactly():
    """The kernel's division by Wo and Ho (a multiply-high and a shift,
    ``kernels._div_by``) equals integer division for every divisor up
    to 2048 and a few larger, at the quotient's edges and at random n in
    [0, 2^31)."""
    rng = np.random.default_rng(11)
    big = (1 << 31) - 1
    for d in [*range(1, 2049), 4095, 4096, 4097, 10007, 65535, 1 << 20, big]:
        edge = {0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, big, big - big % d, big - big % d - 1}
        for n in [*edge, *rng.integers(0, big, 6).tolist()]:
            if 0 <= n <= big:
                assert tk._div_by(n, d) == n // d, (n, d)


# name -> (O, stride, out): the three zoo stems, int8 out at the next conv's
# static scale (their int8-resident chains) and fp32 out at a dynamic scale
STEMS = {f"{name}_{out}": (o, stride, out)
         for name, o, stride in (("yolov2_s1_3_32", 32, 1), ("yolov2_tiny_s1_3_16", 16, 1),
                                 ("yolov4_tiny_s2_3_32", 32, 2))
         for out in ("int8", "fp32")}


@pytest.mark.parametrize("name", list(STEMS))
def test_port_stem_matches_jax_quantized_conv(name):
    """The port's int8 stem (K6, then K4's plain version) against JAX's
    ``quantized_conv`` (jitted, as the JAX detector runs it) on the same
    numpy letterboxed batch, weights and scales at 64 pixels: bit for bit."""
    o, stride, out = STEMS[name]
    spec_kw = dict(index=0, in_channels=3, filters=o, size=3, stride=stride, pad=1,
                   batch_normalize=True, activation="leaky")
    jspec, tspec = jcfg.ConvSpec(**spec_kw), tcfg.ConvSpec(**spec_kw)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.uniform(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)  # a letterbox's range
    x[:, :8] = 0.5  # a letterbox's grey band
    wq = rng.integers(-127, 128, (o, 3, 3, 3)).astype(np.int8)  # the port's layout
    acc_std = np.sqrt(27) * 64.0 * 73.0
    ws = (rng.uniform(0.5, 1.5, o) * 1.5 / acc_std / (1.0 / 127.0)).astype(np.float32)
    b = rng.normal(0, 0.5, o).astype(np.float32)
    kw = {}
    if out == "int8":
        kw["sx"] = np.float32(1.0 / 127.0)
        kw["out_scale"] = np.float32(0.012)
    conv = jax.jit(lambda xx, ww, s, bb, kk: jq.quantized_conv(xx, ww, s, bb, jspec, **kk))
    ref = np.asarray(conv(jnp.asarray(x), jnp.asarray(wq.transpose(1, 2, 3, 0)), jnp.asarray(ws),
                          jnp.asarray(b), {k: jnp.asarray(v) for k, v in kw.items()}))
    ours = tq.quantized_conv(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws),
                             torch.from_numpy(b), tspec,
                             **{k: torch.as_tensor(v) for k, v in kw.items()}).numpy()
    assert ours.shape == ref.shape == (2, (64 - 1) // stride + 1, (64 - 1) // stride + 1, o)
    assert ours.dtype == ref.dtype == (np.int8 if out == "int8" else np.float32)
    if out == "int8":
        assert 0.01 < (np.abs(ref.astype(np.int32)) == 127).mean() < 0.5  # rounds and clips
    np.testing.assert_array_equal(ours, ref)
