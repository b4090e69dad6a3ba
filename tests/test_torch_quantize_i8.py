"""K6 (the int8 input quantizer and ``max|x|``) and the [shortcut] taken
into K3/K4's epilogue, their plain versions against the JAX package on the
CPU.

The JAX side is what XLA:CPU compiles: ``quantized_conv`` quantizes with
``clip(round(x.astype(float32) / sx), -127, 127).astype(int8)``
(``pytorch_yolo_tpu/ops/quant.py:593-596``; each split-concat branch at its
own scale, :577-582), and the forward adds a [shortcut] as
``cache[i - 1] + cache[from]`` (``pytorch_yolo_tpu/models/darknet.py:453``),
which XLA fuses into the conv's epilogue.  Inputs come from numpy seeds.

Tolerances, each with its reason:
  * the quantizer (fp32 and bf16 inputs; a 0-d scale, a (C,) scale, a
    split vector; exact ties at (k + 0.5) * s, values beyond +-127.5 * s,
    and values that a multiply by the reciprocal would round the other way)
    and ``max|x|``: 0 — an IEEE division, round half to even and a clamp,
    or an exact max, on both sides;
  * the epilogue with a shortcut operand: 0 for every activation.
    XLA:CPU contracts mish's last product ``y * tanh(sp)`` into the add
    (one rounding) and rounds every other activation before it; the test
    pins both on JAX's own pieces with the port's ``fma``, and that is what
    the kernels and their plain version compute.  On the CPU the plain
    version's mish factor and logistic are XLA's, bit for bit
    (``ops/xla_mish.py``);
  * the int8 forward of ``SHORTCUT_CFG`` (a leaky and a mish conv before
    its two [shortcut]s, the head conv fp32) with static and dynamic
    scales: the leaky [shortcut]'s output bit-equal to JAX's, the mish
    one's and the heads within the mish tolerance.  With the mish conv made
    leaky and every conv int8 (an fp32 head conv sums in oneDNN's order on
    the CPU and XLA's in JAX: 1.4e-6 apart), the heads are bit-equal.  Fused
    against unfused (a stats hook turns fusion off): bit-equal where no
    product precedes the add; after mish the unfused add rounds the
    product first, so the two differ by at most that rounding plus one of
    the sum's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.ops import quant as jq
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.parallel import sharding as tshard
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.ops.xla_mish import mish_factor
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_conv_bf16 import SHORTCUT_CFG
from tests.test_torch_cuda import plant_division_traps
from tests.torch_threads import one_torch_thread  # noqa: F401

SPLITS = (8, 16, 24)


def _jax_quantize(x, sx):
    return jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)


def quantize_input(dtype, scale, seed=0):
    """(x as a torch tensor, the same values for JAX, sx as a numpy fp32
    array, each channel's scale): (2, 5, 7, 48) with ties at (k + 0.5) * s,
    values past +-127.5 * s, in fp32 division traps where a scale is not a
    power of two (``tests/test_torch_cuda.py: division_traps``), and the
    rest normal; ``scale`` "scalar", "vector" or "split" (a split-concat's
    branch scales, one per ``SPLITS`` group)."""
    rng = np.random.default_rng(seed)
    c = sum(SPLITS)
    if scale == "scalar":
        sx = np.float32(2.0 ** -5)  # a power of two: (k + 0.5) * s divides exactly
        per_ch = np.full(c, sx, np.float32)
    elif scale == "vector":
        per_ch = (2.0 ** rng.integers(-7, -3, c)).astype(np.float32)
        per_ch[::3] = rng.uniform(0.01, 0.05, per_ch[::3].shape)  # and some that are not
        sx = per_ch
    else:
        sx = np.array([2.0 ** -6, 0.0371, 2.0 ** -4], np.float32)
        per_ch = np.repeat(sx, SPLITS)
    x = rng.normal(0.0, 1.5, (2, 5, 7, c)) * (64 * per_ch)
    x[0, 0] = (np.arange(c) % 7 - 3 + 0.5) * per_ch  # k + 0.5 for k in -3..3
    x[0, 1] = (rng.choice([-1, 1], c) * rng.uniform(127.5, 400, c)) * per_ch  # saturates
    x[0, 2, 0] = 127.5 * per_ch  # ties at the clamp's edge
    x[0, 2, 1] = -127.5 * per_ch
    x = x.astype(np.float32)
    if dtype == torch.float32:
        plant_division_traps(x[1], per_ch)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)  # exact: the values are bf16 already
    return xt, xj, np.asarray(sx, np.float32), per_ch


@pytest.mark.parametrize("scale", ["scalar", "vector", "split", "sources", "mixed_sources"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_i8_plain_matches_jax(dtype, scale):
    """``split``: the concat's channel slices at their branch scales;
    ``sources``: a route's sources handed over as they are (the forward's
    read-through), ``mixed_sources`` every other one in the other dtype, as
    fp32 int8-conv outputs meet bf16 glue; both against JAX's slices of its
    concatenation."""
    if scale.endswith("sources"):
        xt, _, sx, per_ch = quantize_input(dtype, "split")
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        offs = np.cumsum((0,) + SPLITS)
        srcs = [xt[..., o:o + c].contiguous().to(other if scale == "mixed_sources" and g % 2
                                                 else dtype)
                for g, (o, c) in enumerate(zip(offs, SPLITS))]
        xj = jnp.concatenate([jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for t in srcs], -1)
        assert xj.dtype == (jnp.float32 if scale == "mixed_sources" or dtype == torch.float32
                            else jnp.bfloat16)
        ref = np.concatenate([np.asarray(jax.jit(_jax_quantize)(xj[..., o:o + c],
                                                               jnp.asarray(sx[g])))
                              for g, (o, c) in enumerate(zip(offs, SPLITS))], -1)
        ours = tk.quantize_i8(srcs, [torch.tensor(v) for v in sx])
        assert ours.dtype == torch.int8 and tuple(ours.shape) == ref.shape
        np.testing.assert_array_equal(ours.numpy(), ref)
        wide = torch.cat([t.float() for t in srcs], -1)  # one scale: the same as the copy's
        np.testing.assert_array_equal(tk.quantize_i8(srcs, torch.tensor(sx[1])).numpy(),
                                      tk.quantize_i8(wide, torch.tensor(sx[1])).numpy())
        assert (np.abs(ref) == 127).mean() > 0.1
        return
    xt, xj, sx, per_ch = quantize_input(dtype, scale)
    if scale == "split":  # the JAX slice loop against one launch over the slices
        ref, off = [], 0
        for g, c in enumerate(SPLITS):
            ref.append(jax.jit(_jax_quantize)(xj[..., off:off + c], jnp.asarray(sx[g])))
            off += c
        ref = np.concatenate([np.asarray(r) for r in ref], -1)
        offs = np.cumsum((0,) + SPLITS)  # the concat's channel slices, one launch
        ours = tk.quantize_i8([xt[..., o:o + c] for o, c in zip(offs, SPLITS)],
                              [torch.tensor(v) for v in sx])
    else:
        ref = np.asarray(jax.jit(_jax_quantize)(xj, jnp.asarray(sx)))
        ours = tk.quantize_i8(xt, torch.from_numpy(sx))
    assert ours.dtype == torch.int8 and tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    ties = xt[0, 0].float() / torch.from_numpy(per_ch)
    assert bool((ties.frac().abs() == 0.5).any())  # exact ties were rounded half to even
    assert (np.abs(ref) == 127).mean() > 0.1      # and the clamp was reached
    if dtype == torch.float32 and scale != "scalar":  # a reciprocal would round some elsewhere
        xf = xt.numpy()
        assert (np.rint(xf / per_ch) != np.rint(xf * (np.float32(1) / per_ch))).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absmax_plain_matches_jax(dtype):
    """``max|x|`` and the dynamic scale built on it, bit for bit; the
    largest magnitude is negative, and a channels_last view reads as its
    values."""
    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 2.0, (2, 6, 6, 40)).astype(np.float32)
    x[1, 3, 2, 7] = -41.25
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda a: jnp.max(jnp.abs(a)).astype(jnp.float32))(xj))
    for view in (xt, xt.permute(0, 3, 1, 2)):
        ours = tk.absmax(view)
        assert ours.dtype == torch.float32 and ours.dim() == 0
        np.testing.assert_array_equal(ours.numpy(), ref)
    assert float(ref) == 41.25
    scale = jax.jit(lambda a: jnp.max(jnp.abs(a.astype(jnp.float32))) / 127.0 + jq._QEPS)(xj)
    np.testing.assert_array_equal(tq.dynamic_scale(xt).numpy(), np.asarray(scale))
    # over a route's sources (the read-through): the max and the scale of
    # their concatenation, from the reduction's own call
    srcs = [xt[..., :16].contiguous(), xt[..., 16:].to(torch.float32)]
    np.testing.assert_array_equal(tk.absmax(srcs).numpy(), ref)
    np.testing.assert_array_equal(tk.absmax(srcs, scale=True).numpy(), np.asarray(scale))
    np.testing.assert_array_equal(tq.dynamic_scale(srcs).numpy(), np.asarray(scale))


def test_dynamic_scale_matches_jax():
    """The fused scale ``absmax(x, scale=True)`` (the plain version here:
    ``scale_of_amax``, an emulated fp32 FMA) against JAX's
    ``jnp.max(jnp.abs(x)) / 127.0 + _QEPS`` as XLA compiles it, bit for
    bit, for 1,200 values of the max: 0, every power of two (the subnormal
    ones too), random subnormals, and values over the normal range; and
    XLA's fp32 constants are those of ``csrc/quantize_i8.cu`` (kInv127,
    kEps)."""
    rng = np.random.default_rng(3)
    ms = np.concatenate([[0.0], 2.0 ** np.arange(-149, 128),
                         rng.integers(1, 1 << 23, 100).astype(np.uint32).view(np.float32),
                         np.exp(rng.uniform(-80, 80, 822))]).astype(np.float32)
    rows = np.stack([ms / 2, -ms, ms / 4], -1)
    ref = np.asarray(jax.jit(jax.vmap(lambda r: jnp.max(jnp.abs(r)) / 127.0 + jq._QEPS))(rows))
    ours = np.array([tk.absmax(torch.from_numpy(r), scale=True).numpy() for r in rows])
    np.testing.assert_array_equal(ours, ref)
    assert float(np.float32(1.0 / 127.0)).hex() == "0x1.0204080000000p-7"  # kInv127
    assert float(np.float32(jq._QEPS)).hex() == "0x1.1979980000000p-40"    # kEps


def _epilogue_pieces(act, seed):
    rng = np.random.default_rng(seed)
    acc = rng.integers(-40000, 40000, (4096,)).astype(np.int32)
    deq, b = np.float32(7.3e-5), np.float32(-0.2)
    s = rng.normal(0.0, 1.0, acc.shape).astype(np.float32)
    return acc, deq, b, s


@pytest.mark.parametrize("sdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["leaky", "mish", "relu", "linear", "logistic"])
def test_shortcut_epilogue_matches_xla_fusion(act, sdtype):
    """K3/K4's fp32 epilogue with a shortcut operand (the plain version)
    against JAX's ``act(acc * deq + b) + s`` compiled in one fusion; and
    which of the two roundings XLA:CPU takes, pinned on its own pieces."""
    acc, deq, b, s = _epilogue_pieces(act, 4)
    sj = jnp.asarray(s).astype(sdtype)
    st = torch.from_numpy(s).to(getattr(torch, sdtype))
    fused = jax.jit(lambda a, ss: jdn.apply_activation(a.astype(jnp.float32) * deq + b, act) + ss)
    ref = np.asarray(fused(acc, sj))
    assert ref.dtype == np.float32  # fp32 + bf16 promotes to fp32, as in torch
    ours = tk._serving_epilogue(torch.from_numpy(acc).float(), torch.tensor(deq), torch.tensor(b),
                                act, None, None, st).numpy()
    np.testing.assert_array_equal(ours, ref)  # logistic too: XLA's sigmoid on the CPU
    # each side's pieces: the pre-activation, and the activation (or mish's
    # tanh); the port's pre-activation equals XLA's bit for bit
    pre = np.array(jax.jit(lambda a: a.astype(jnp.float32) * deq + b)(acc))
    sw = np.array(sj.astype(jnp.float32))
    pre_t = tk.fma(torch.from_numpy(acc).float(), torch.tensor(deq), torch.tensor(b))
    np.testing.assert_array_equal(pre_t.numpy(), pre)
    if act == "mish":
        th = np.array(jax.jit(lambda y: jnp.tanh(jnp.log1p(jnp.exp(-jnp.abs(y)))
                                                  + jnp.maximum(y, 0.0)))(pre))
        contracted = tk.fma(torch.from_numpy(pre), torch.from_numpy(th), torch.from_numpy(sw))
        np.testing.assert_array_equal(contracted.numpy(), ref)  # one rounding
        assert ((pre * th) + sw != ref).any()  # rounding the product first differs
        y_t, th_t = mish_factor(pre_t)
        np.testing.assert_array_equal(th_t.numpy(), th)  # XLA's tanh(softplus(y)), bit for bit
        np.testing.assert_array_equal(ours, tk.fma(y_t, th_t, torch.from_numpy(sw)).numpy())
    else:
        y = np.asarray(jax.jit(lambda a: jdn.apply_activation(a, act))(pre))
        np.testing.assert_array_equal(y + sw, ref)  # rounded, then added
        y_t = tk._activate(pre_t.clone(), act)  # logistic: ops/xla_mish.py's, XLA's bits
        np.testing.assert_array_equal(y_t.numpy(), y)
        np.testing.assert_array_equal(ours, (y_t + torch.from_numpy(sw)).numpy())


LEAKY_SHORTCUT_CFG = SHORTCUT_CFG.replace("activation=mish", "activation=leaky")


def _model_pair(text, mode, skip):
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=3))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    act = None
    if mode == "static":
        act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    qp = jq.quantize_params(jspec, jp, skip, act)
    qj = jax.tree_util.tree_map(jnp.asarray, qp)
    model = tdn.Darknet(tspec, tq.quantize_params(tspec, params_from_jax(jp), skip, act),
                        quant="w8a8")
    return jspec, qj, model, x


def _run(model, x, hooked):
    outs = {}
    model.layer_hook = lambda i, t: outs.__setitem__(i, t.permute(0, 2, 3, 1).clone())
    kw = {"collect_conv_in_stats": (lambda i, t: None)} if hooked else {}
    heads = model(torch.from_numpy(x), **kw)
    model.layer_hook = None
    return (heads[0] if hooked else heads), outs


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("cfg", ["shortcuts", "shortcuts_leaky"])
def test_int8_forward_fused_shortcuts_matches_jax(cfg, mode):
    """The w8a8 forward with both [shortcut]s in K3/K4's epilogue (the plain
    versions here) against JAX's ``build_forward(quant="w8a8")``, and
    against its own unfused run."""
    leaky = cfg == "shortcuts_leaky"
    jspec, qj, model, x = _model_pair(LEAKY_SHORTCUT_CFG if leaky else SHORTCUT_CFG, mode,
                                      () if leaky else "heads")
    assert model._fused == frozenset({3, 5})
    assert set(model._qconv_at) == ({0, 1, 2, 3, 5, 7} if leaky else {0, 1, 2, 3, 5})
    if mode == "static":
        assert model._chains == {0: 1, 2: 3}
    before = dict(tk.LAUNCHES)
    heads, outs = _run(model, x, hooked=False)
    assert tk.LAUNCHES == before  # CPU tensors: the plain versions, no launch
    ref = jax.jit(jdn.build_forward(jspec, quant="w8a8"))(qj, jnp.asarray(x))
    for i in (4, 6):  # the [shortcut]s' outputs
        at = jax.jit(jdn.build_forward(jspec, quant="w8a8", stop_at=i))(qj, jnp.asarray(x))[0]
        if leaky or i == 4:
            np.testing.assert_array_equal(outs[i].numpy(), np.asarray(at))
        else:
            np.testing.assert_allclose(outs[i].numpy(), np.asarray(at), rtol=1e-5, atol=1e-5)
    for o, r in zip(heads, ref):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        if leaky:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)

    unfused_heads, plain = _run(model, x, hooked=True)
    np.testing.assert_array_equal(plain[4].numpy(), outs[4].numpy())
    if leaky:
        for o, u in zip(heads, unfused_heads):
            assert torch.equal(o, u)
        return
    # after mish: round(round(p) + s) against round(p + s), p = y * tanh(sp)
    fused6, unfused6, p = outs[6].numpy(), plain[6].numpy(), plain[5].numpy()
    gap = np.abs(fused6 - unfused6)
    limit = np.spacing(np.abs(p)) + np.spacing(np.maximum(np.abs(fused6), np.abs(unfused6)))
    assert (gap <= limit).all() and (gap > 0).mean() < 0.5


# A [route] of two sources (an upsampled 1x1 conv and the first conv's
# output, 8 + 16 channels) that only the next conv reads: the w8a8 forward
# hands the sources to that conv's K6 (``Darknet._read_through``)
ROUTE_CFG = """
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
filters=24
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1, 0

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

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


def _float_cats(monkeypatch):
    """Count the ``torch.cat`` calls on floating tensors (a route's
    concatenated copy; the plain quantizer's cat of int8 parts is not one)."""
    calls = []
    cat = torch.cat

    def counting(tensors, *args, **kwargs):
        if any(t.is_floating_point() for t in tensors):
            calls.append(tuple(t.shape for t in tensors))
        return cat(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "cat", counting)
    return calls


@pytest.mark.parametrize("model,mode", [("yolov3-tiny", "static"), ("yolov3-tiny", "dynamic"),
                                        ("route", "split"), ("route", "dynamic_mesh")])
def test_int8_forward_reads_route_concats_matches_jax(model, mode, monkeypatch):
    """The w8a8 forward with its concat routes read through by the next
    conv's K6 (the plain versions here) against JAX's
    ``build_forward(quant="w8a8")``, bit for bit, with no ``torch.cat`` of
    the route's sources; with a layer hook the route is concatenated again
    and the heads are the same.  yolov3-tiny (route 20) at static and
    dynamic scales; ``ROUTE_CFG`` with every conv int8 at per-branch static
    scales (``sag``), and with dynamic scales on a 2-entry CPU mesh (each
    shard's max over the sources, the whole batch's scale: the heads of
    one device and of JAX)."""
    if model == "yolov3-tiny":
        text = open("cfg/yolov3-tiny.cfg", encoding="utf-8").read()
        skip, size, route = (), 96, 20
    else:
        text, skip, size, route = ROUTE_CFG, (), 64, 4
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=3))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(8).uniform(0, 1, (4 if mode.endswith("mesh") else 2, size, size,
                                                3)).astype(np.float32)
    act = None
    if mode == "static":
        act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    elif mode == "split":
        rng = np.random.default_rng(4)
        groups = tq.concat_split_groups(tspec)
        assert groups == {5: (8, 16)}
        act = {i: ([float(v) for v in rng.uniform(0.01, 0.05, len(groups[i]))]
                   if i in groups else float(rng.uniform(0.01, 0.05))) for i in jp}
    qp = jq.quantize_params(jspec, jp, skip, act)
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, params_from_jax(jp), skip, act),
                      quant="w8a8")
    assert net._read_through == {route}
    ref = jax.jit(jdn.build_forward(jspec, quant="w8a8"))(
        jax.tree_util.tree_map(jnp.asarray, qp), jnp.asarray(x))

    cats = _float_cats(monkeypatch)
    if mode.endswith("mesh"):
        mesh = tshard.make_batch_mesh(["cpu", "cpu"])
        shards = tshard.shard_batch(x, mesh)
        per_shard = tdn.Darknet.forward_mesh([net, net], shards)
        assert cats == []
        heads = [torch.cat(h) for h in zip(*per_shard)]
        cats.clear()
    else:
        heads = net(torch.from_numpy(x))
    assert cats == []
    for o, r in zip(heads, ref):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if mode.endswith("mesh"):  # the mesh's heads are one device's
        for o, one in zip(heads, net(torch.from_numpy(x))):
            assert torch.equal(o, one)

    net.layer_hook = lambda i, t: None  # a reader of the route: the copy comes back
    hooked = net(torch.from_numpy(x))
    net.layer_hook = None
    assert len(cats) == 1
    for o, h in zip(heads, hooked):
        assert torch.equal(o, h)


@pytest.mark.parametrize("case", ["contiguous", "channel_slices", "sources", "vector",
                                  "strided_copy"])
def test_quant_args_describe_branches(case):
    """The launch arguments K6's wrapper builds (``kernels._rows_view``,
    ``_quant_args``), which only the card runs: each branch's pointer, rows,
    channels, row stride, output channel offset, element size and scale;
    a channel slice is read in place at its parent's row stride, a view
    whose rows do not sit one stride apart is copied; ``absmax``'s dense
    branches are one flat run whatever their memory order."""
    x = torch.arange(2 * 3 * 5 * 48, dtype=torch.float32).reshape(2, 3, 5, 48)
    s = torch.tensor([0.5, 0.25, 0.125])
    out = torch.empty((2, 3, 5, 48), dtype=torch.int8)
    if case == "contiguous":
        xs, scales = [x], [s[0]]
    elif case == "channel_slices":
        xs, scales = [x[..., :16], x[..., 16:40], x[..., 40:]], [s[0], s[1], s[2]]
    elif case == "sources":
        xs, scales = [x[..., :16].contiguous(), x[..., 16:].to(torch.bfloat16)], [s[0], s[1]]
    elif case == "vector":
        xs = [x[..., :16], x[..., 16:]]
        scales = tk._branch_scales(xs, torch.linspace(0.1, 0.2, 48))
    else:
        xs, scales = [x[:, :, 1:, :]], [s[0]]  # rows two strides apart: copied
    views = [tk._rows_view(t) for t in xs]
    args = tk._quant_args(views, scales, out, 48)
    assert args.branches == len(xs) and args.out_channels == 48
    assert args.out == out.data_ptr()
    off = 0
    for g, (t, (v, rows, c, stride)) in enumerate(zip(xs, views)):
        b = args.b[g]
        assert (b.rows, b.channels, b.out_offset, b.elem_bytes) == (
            t.numel() // t.shape[-1], t.shape[-1], off, t.element_size())
        assert b.scale == scales[g].data_ptr()
        assert b.scale_vec == int(scales[g].dim() == 1)
        if case in ("channel_slices", "vector"):
            assert v is t and b.x == t.data_ptr() and b.row_stride == 48
        elif case == "strided_copy":
            assert v is not t and v.is_contiguous() and b.row_stride == c == 48
        else:
            assert b.x == t.data_ptr() and b.row_stride == c
        off += c
    if case == "vector":  # each branch its slice of the per-channel vector
        assert args.b[1].scale - args.b[0].scale == 16 * 4
    nchw = x.permute(0, 3, 1, 2)  # a channels_last NCHW view: absmax reads it flat
    flat, sliced = tk._absmax_views([nchw, x[..., 16:]])
    assert flat[0] is nchw and flat[1:] == (x.numel(), 1, 1)
    assert sliced[0].data_ptr() == x[..., 16:].data_ptr() and sliced[1:] == (30, 32, 48)
    with pytest.raises(ValueError, match="sx must be"):
        tk._branch_scales([x[..., :16], x[..., 16:]], torch.ones(47))
