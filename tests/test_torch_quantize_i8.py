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
  * the epilogue with a shortcut operand: 0 for leaky, relu and linear.
    XLA:CPU contracts mish's last product ``y * tanh(sp)`` into the add
    (one rounding) and rounds every other activation before it; the test
    pins both on JAX's own pieces with the port's ``fma``, and that is what
    the kernels and their plain version compute.  The port's mish and
    logistic themselves differ from XLA's ``exp``/``log1p``/``tanh`` in the
    last ulps (``tests/test_torch_quant.py``): rtol = atol = 1e-5 there;
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
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_conv_bf16 import SHORTCUT_CFG
from tests.test_torch_cuda import plant_division_traps

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


@pytest.mark.parametrize("scale", ["scalar", "vector", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_i8_plain_matches_jax(dtype, scale):
    xt, xj, sx, per_ch = quantize_input(dtype, scale)
    if scale == "split":  # the JAX slice loop against one launch at the split vector
        ref, off = [], 0
        for g, c in enumerate(SPLITS):
            ref.append(jax.jit(_jax_quantize)(xj[..., off:off + c], jnp.asarray(sx[g])))
            off += c
        ref = np.concatenate([np.asarray(r) for r in ref], -1)
        sv = tq.split_scale_vector(torch.from_numpy(sx), SPLITS)
        np.testing.assert_array_equal(sv.numpy(), np.repeat(sx, SPLITS))
        ours = tk.quantize_i8(xt, sv)
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
    if act in ("leaky", "relu", "linear"):
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
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
        th_t = torch.tanh(torch.log1p(torch.exp(-pre_t.abs())) + pre_t.clamp(min=0.0))
        np.testing.assert_array_equal(ours, tk.fma(pre_t, th_t, torch.from_numpy(sw)).numpy())
    else:
        y = np.asarray(jax.jit(lambda a: jdn.apply_activation(a, act))(pre))
        np.testing.assert_array_equal(y + sw, ref)  # rounded, then added
        y_t = tdn.apply_activation(pre_t.clone(), act)
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
