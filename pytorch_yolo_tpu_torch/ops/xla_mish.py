"""mish and logistic as the JAX package's compiled int8 epilogue computes them on the CPU.

XLA:CPU does not call a math library for ``exp``, ``log1p`` and ``tanh``:
it inlines polynomial approximations (Cephes' ``expf`` and ``logf``, a
rational ``log1p`` below 0.4142, Eigen's rational ``tanh``), contracts each
multiply that feeds one add into a fused multiply-add, and runs with
denormals flushed to zero.  torch's own ``exp``/``log1p``/``tanh`` differ
from those in the last ulp on about half of all inputs, and in an int8
epilogue one ulp before a requant can move an int8 value, which the next
layers carry on.  :func:`mish_factor` repeats XLA's operations in fp32, one
rounding each, every contracted pair as one :func:`~.kernels.fma`, so the
plain K3/K4 epilogue on the CPU gives the JAX package's bits on a mish
model (``tests/test_torch_yolov4.py`` holds them equal on 2^23 inputs and
through yolov4's int8 forward).  :func:`logistic` does the same for
``jax.nn.sigmoid``, which XLA compiles to ``1 / (exp(-y) + 1)`` on the same
``exp`` (the Scaled-YOLOv4 head convs; ``tests/test_torch_csp.py``).  The
card's kernels keep the CUDA math library's ``expf``/``log1pf``/``tanhf``,
as torch's CUDA kernels do, and their plain version on the card keeps
torch's.
"""

from __future__ import annotations

import struct

import torch


def _f32(bits: int) -> float:
    """The fp32 value of a bit pattern (the constants as XLA emits them)."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


_FLT_MIN = _f32(0x00800000)
# exp(t): t clamped to [-87.8, 88.8], n = floor(t log2 e + 1/2), r = t - n ln 2
# in two steps (ln 2 = 0.693359375 - 2.12194440e-4), a degree-5 polynomial
_EXP_LO, _EXP_HI, _LOG2E = _f32(0xC2AF999A), _f32(0x42B1999A), _f32(0x3FB8AA3B)
_LN2_HI, _LN2_LO = _f32(0x3F318000), _f32(0xB95E8083)
_EXP_P = tuple(_f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA))
# log(u): u = m 2^e with m in [sqrt(1/2), sqrt(2)), three interleaved polynomials
_SQRT_HALF = _f32(0x3F3504F3)
_LOG_P = tuple(_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                                 0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
# log1p(e) for |e| < 0.4142: e - e^2/2 + e^3 N(e) / D(e)
_L1P_SMALL = _f32(0x3ED413CD)
_L1P_N = tuple(_f32(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
                                 0x426473AD, 0x41A05101))
_L1P_D = tuple(_f32(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
                                 0x42707982))
# tanh(x): x below 4e-4, +-1 from 20, else x P(x^2) / Q(x^2) on x clamped to 7.9988
_TANH_SMALL, _TANH_CLAMP = _f32(0x39D1B717), _f32(0x40FFF644)
_TANH_P = tuple(_f32(b) for b in (0xA59F25C0, 0x2A61337E, 0xAEBD37FF, 0x335C0041, 0x3779434A,
                                  0x3A270DED, 0x3BA059DC))
_TANH_Q = tuple(_f32(b) for b in (0x35A0D3D8, 0x38F895D6, 0x3B14AA05, 0x3BA059DD))


def _c(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once; an argument may be a constant."""
    from .kernels import fma  # kernels imports this module

    return fma(*(t if isinstance(t, torch.Tensor) else _c(t) for t in (a, b, c)))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign, as XLA:CPU's flush-to-zero mode."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _exp_parts(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """exp(t) of XLA:CPU as (q, 2^n), exp(t) = q 2^n, with ``t`` already
    clamped to [-87.8, 88.8]: the caller rounds the product (mish) or fuses
    it into the next add (logistic)."""
    n = torch.clamp(torch.floor(_fma(t, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(-n, _LN2_LO, _fma(-n, _LN2_HI, t))
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + (0.5,):
        p = _fma(p, r, c)
    two_n = ((torch.nan_to_num(n).to(torch.int32) << 23) + 0x3F800000).view(torch.float32)
    return _fma(p, r * r, r) + 1.0, two_n


def _exp_neg_abs(y: torch.Tensor) -> torch.Tensor:
    q, two_n = _exp_parts(torch.clamp(-y.abs(), _EXP_LO, _EXP_HI))
    return _flush(q * two_n)


def _log(u: torch.Tensor) -> torch.Tensor:
    """log(u) for u >= 1 (or NaN), as XLA:CPU computes it."""
    bits = torch.clamp(u, min=_FLT_MIN).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0 - low.to(torch.float32)
    z = x * x
    x3 = z * x
    p = _fma(_fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    p1 = _fma(_fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    p2 = _fma(_fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    p = _fma(_fma(_fma(p, x3, p1), x3, p2), x3, e * _LN2_LO)
    out = _fma(e, _LN2_HI, _fma(-0.5, z, x) + p)
    return torch.where(torch.isnan(u), u, out)


def _log1p_small(e: torch.Tensor) -> torch.Tensor:
    zero = e * 0.0
    num, den = zero + _L1P_N[0], zero + 1.0
    for c in _L1P_N[1:]:
        num = _fma(num, e, c)
    for c in _L1P_D:
        den = _fma(den, e, c)
    e2 = e * e
    return e + _fma(-0.5, e2, (e * e2) * (num / den))


def _tanh(x: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    s = c * c
    p = _fma(s, _TANH_P[0], _TANH_P[1])
    for a in _TANH_P[2:]:
        p = _fma(s, p, a)
    q = _fma(s, _TANH_Q[0], _TANH_Q[1])
    for b in _TANH_Q[2:]:
        q = _fma(s, q, b)
    t = torch.where(x.abs() < _TANH_SMALL, x, (c * p) / q)
    return torch.where(x.abs() >= 20.0, torch.copysign(torch.ones_like(x), x), t)


def mish_factor(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, tanh(softplus(y))) of fp32 ``y`` with XLA:CPU's bits, ``y`` with
    its subnormals flushed: mish is their product (or, before a [shortcut],
    their product fused into the add)."""
    y = _flush(y)
    e = _exp_neg_abs(y)
    small = e.abs() < _L1P_SMALL  # each element takes one of log1p's two branches
    sp = torch.empty_like(e)
    sp[small] = _log1p_small(e[small])
    sp[~small] = _log(e[~small] + 1.0)
    return y, _tanh(sp + torch.clamp(y, min=0.0))


def logistic(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of fp32 ``y`` with XLA:CPU's bits: ``1 / (q 2^n +
    1)`` with exp(-y) = q 2^n (:func:`_exp_parts`), the product fused into
    the add, subnormal inputs and outputs flushed.  torch's ``sigmoid``
    differs by up to 3 ulps on about 0.4 % of inputs and keeps the
    subnormal outputs that XLA:CPU flushes."""
    q, two_n = _exp_parts(torch.clamp(-_flush(y), _EXP_LO, _EXP_HI))
    out = _flush(1.0 / _fma(q, two_n, 1.0))
    return torch.where(torch.isnan(y), y, out)
