"""Darknet ``.weights`` binary IO and the port's parameter dictionaries.

Counterpart of ``pytorch_yolo_tpu/weights.py`` (reading, BatchNorm folding,
synthetic init), carried as a copy because that package imports jax.  The
format is a flat float32 stream consumed in cfg order, conv layers only:

    header:  int32 major, int32 minor, int32 revision
             if major*10+minor >= 2:  uint64 seen   else:  int32 seen
    body:    per conv layer, in cfg order:
             if batch_normalize: bn_bias[o], bn_scale[o], bn_rmean[o], bn_rvar[o]
             else:               conv_bias[o]
             then conv_weight in (out, in, kh, kw) row-major order

Where the JAX package holds kernels HWIO (its TPU conv layout), this port
holds them **OIHW** — Darknet's stream order and ``F.conv2d``'s layout — so
reading is a reshape with no transpose.  :func:`params_from_jax` converts a
JAX params dict, and :func:`random_raw_params` makes the JAX package's draws
in the same order from the same seed, so both packages get the same numbers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .config import ConvSpec, ModelSpec

BN_EPS = 1e-5  # Darknet batch_normalize epsilon

Params = dict[int, dict[str, np.ndarray]]
RawParams = dict[int, dict[str, np.ndarray]]


class WeightsError(ValueError):
    """Raised for truncated / oversized / malformed .weights content."""


def _conv_specs(spec: ModelSpec) -> list[ConvSpec]:
    return [l for l in spec.layers if isinstance(l, ConvSpec)]


def param_count(spec: ModelSpec) -> int:
    """Total float32 count of the body stream for this model."""
    n = 0
    for c in _conv_specs(spec):
        n += 4 * c.filters if c.batch_normalize else c.filters
        n += c.filters * c.in_channels * c.size * c.size
    return n


def read_weights_file(spec: ModelSpec, path: str) -> RawParams:
    """Parse a Darknet .weights file into raw (un-folded) per-layer arrays.

    Returns {conv_layer_index: {"w": (out, in, kh, kw) f32,
                                "bn_beta"/"bn_gamma"/"bn_mean"/"bn_var" or "b"}}.
    """
    with open(path, "rb") as f:
        data = f.read()
    return read_weights_bytes(spec, data)


def read_weights_bytes(spec: ModelSpec, data: bytes) -> RawParams:
    if len(data) < 12:
        raise WeightsError("file shorter than header")
    major, minor, revision = (int(v) for v in np.frombuffer(data, dtype=np.int32, count=3))
    offset = 12 + (8 if major * 10 + minor >= 2 else 4)  # uint64 / int32 seen
    if len(data) < offset:
        raise WeightsError(f"file shorter than v{major}.{minor} header")
    if (len(data) - offset) % 4:
        raise WeightsError("weight stream length is not a multiple of 4 bytes")

    flat = np.frombuffer(data, dtype=np.float32, offset=offset)
    expected = param_count(spec)
    if flat.size != expected:
        raise WeightsError(
            f"weight stream has {flat.size} floats, model needs {expected} "
            f"(header v{major}.{minor}.{revision})"
        )

    params: RawParams = {}
    ptr = 0

    def take(n: int) -> np.ndarray:
        nonlocal ptr
        out = flat[ptr : ptr + n]
        ptr += n
        return out.copy()

    for c in _conv_specs(spec):
        entry: dict[str, np.ndarray] = {}
        if c.batch_normalize:
            entry["bn_beta"] = take(c.filters)
            entry["bn_gamma"] = take(c.filters)
            entry["bn_mean"] = take(c.filters)
            entry["bn_var"] = take(c.filters)
        else:
            entry["b"] = take(c.filters)
        entry["w"] = take(c.filters * c.in_channels * c.size * c.size).reshape(
            c.filters, c.in_channels, c.size, c.size)
        params[c.index] = entry
    return params


def fold_batchnorm(spec: ModelSpec, raw: RawParams) -> Params:
    """Fold BN statistics into conv weight/bias for inference.

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x) * s + (beta - mean * s),   s = gamma / sqrt(var + eps)
    """
    params: Params = {}
    for c in _conv_specs(spec):
        entry = raw[c.index]
        w = entry["w"]
        if c.batch_normalize:
            s = entry["bn_gamma"] / np.sqrt(entry["bn_var"] + BN_EPS)
            params[c.index] = {
                "w": (w * s[:, None, None, None]).astype(np.float32),
                "b": (entry["bn_beta"] - entry["bn_mean"] * s).astype(np.float32),
            }
        else:
            params[c.index] = {"w": w.astype(np.float32), "b": entry["b"].astype(np.float32)}
    return params


def random_raw_params(spec: ModelSpec, seed: int = 0, scale: float = 0.05) -> RawParams:
    """He-style random raw params for every conv layer (tests/benchmarks).

    Draws exactly what ``pytorch_yolo_tpu.weights.random_raw_params`` draws,
    in the same order (kernels are drawn HWIO, then laid out OIHW)."""
    rng = np.random.default_rng(seed)
    raw: RawParams = {}
    for c in _conv_specs(spec):
        fan_in = c.in_channels * c.size * c.size
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(c.size, c.size, c.in_channels, c.filters))
        entry: dict[str, np.ndarray] = {
            "w": np.ascontiguousarray(w.astype(np.float32).transpose(3, 2, 0, 1))}
        if c.batch_normalize:
            entry["bn_beta"] = rng.normal(0, scale, c.filters).astype(np.float32)
            entry["bn_gamma"] = (1.0 + rng.normal(0, scale, c.filters)).astype(np.float32)
            entry["bn_mean"] = rng.normal(0, scale, c.filters).astype(np.float32)
            entry["bn_var"] = (1.0 + np.abs(rng.normal(0, scale, c.filters))).astype(np.float32)
        else:
            entry["b"] = rng.normal(0, scale, c.filters).astype(np.float32)
        raw[c.index] = entry
    return raw


def params_from_jax(params: Mapping[int, Mapping[str, np.ndarray]]) -> Params:
    """JAX package params ``{idx: {"w": HWIO, "b"}}`` -> ``{idx: {"w": OIHW, "b"}}``."""
    return {
        int(i): {"w": np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)),
                 "b": np.asarray(p["b"], np.float32)}
        for i, p in params.items()
    }
