"""Darknet ``.weights`` binary IO and the port's parameter dictionaries.

Counterpart of ``pytorch_yolo_tpu/weights.py`` (reading, writing, the
native loader, BatchNorm folding, synthetic init), carried as a copy
because that package imports jax.  The format is a flat float32 stream
consumed in cfg order, conv layers only:

    header:  int32 major, int32 minor, int32 revision
             if major*10+minor >= 2:  uint64 seen   else:  int32 seen
    body:    per conv layer, in cfg order:
             if batch_normalize: bn_bias[o], bn_scale[o], bn_rmean[o], bn_rvar[o]
             else:               conv_bias[o]
             then conv_weight in (out, in, kh, kw) row-major order

:func:`equalize_raw_params` (LSUV variance equalization, the
``synthetic="live"`` weights) runs the port's own forward.

Where the JAX package holds kernels HWIO (its TPU conv layout), this port
holds them **OIHW** — Darknet's stream order and ``F.conv2d``'s layout — so
reading and writing are reshapes with no transpose, and the C++ loader
(``native/``) folds without one.  :func:`params_from_jax` converts a
JAX params dict, and :func:`random_raw_params` makes the JAX package's draws
in the same order from the same seed, so both packages get the same numbers.
"""

from __future__ import annotations

import os
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


def load_weights_native(spec: ModelSpec, path: str, n_threads: int = 0) -> "Params | None":
    """Folded OIHW params via the C++ loader (mmap + fused fold).

    Returns None when the native library is unavailable (no compiler etc.);
    raises WeightsError for malformed files.  Equal to
    ``fold_batchnorm(read_weights_file(...))`` up to the fp32 rounding of
    the fold arithmetic."""
    import ctypes

    from .native import LayerDescStruct, load_library

    lib = load_library()
    if lib is None:
        return None
    convs = _conv_specs(spec)
    params: Params = {}
    descs = (LayerDescStruct * len(convs))()
    offset = 0
    for i, c in enumerate(convs):
        w = np.empty((c.filters, c.in_channels, c.size, c.size), dtype=np.float32)
        b = np.empty((c.filters,), dtype=np.float32)
        params[c.index] = {"w": w, "b": b}
        descs[i].filters = c.filters
        descs[i].in_channels = c.in_channels
        descs[i].size = c.size
        descs[i].batch_normalize = int(c.batch_normalize)
        descs[i].stream_offset = offset
        descs[i].out_w = w.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        descs[i].out_b = b.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        offset += (4 if c.batch_normalize else 1) * c.filters
        offset += c.filters * c.in_channels * c.size * c.size
    rc = lib.pyt_load_weights(path.encode(), descs, len(convs), offset, n_threads)
    if rc != 0:
        raise WeightsError(f"native loader: {lib.pyt_strerror(rc).decode()} ({path})")
    return params


def load_weights(spec: ModelSpec, path: str, fold_bn: bool = True,
                 native: "bool | None" = None) -> "Params | RawParams":
    """One call: .weights file -> inference-ready params (OIHW, BN folded).

    ``native=None`` tries the C++ loader for the folded case and falls back
    to numpy; True requires it; False skips it."""
    if fold_bn and native is not False:
        try:
            params = load_weights_native(spec, path)
        except WeightsError:
            raise
        except Exception:
            params = None
        if params is not None:
            return params
        if native:
            raise RuntimeError("native weights loader unavailable")
    raw = read_weights_file(spec, path)
    return fold_batchnorm(spec, raw) if fold_bn else raw


def write_weights_file(
    spec: ModelSpec,
    raw: Mapping[int, Mapping[str, np.ndarray]],
    path: str,
    seen: int = 0,
    version: tuple[int, int, int] = (0, 2, 0),
) -> None:
    """Serialize raw (un-folded) OIHW params to Darknet .weights format:
    the bytes ``pytorch_yolo_tpu.weights.write_weights_file`` writes for
    the same numbers held HWIO."""
    major, minor, revision = version
    chunks: list[bytes] = [np.array([major, minor, revision], dtype=np.int32).tobytes()]
    seen_type = np.uint64 if major * 10 + minor >= 2 else np.int32
    chunks.append(np.array([seen], dtype=seen_type).tobytes())
    for c in _conv_specs(spec):
        entry = raw[c.index]
        keys = ("bn_beta", "bn_gamma", "bn_mean", "bn_var") if c.batch_normalize else ("b",)
        for key in keys:
            chunks.append(np.asarray(entry[key], dtype=np.float32).tobytes())
        chunks.append(np.ascontiguousarray(entry["w"], dtype=np.float32).tobytes())
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(chunks))
    os.replace(tmp, path)


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


def equalize_raw_params(spec: ModelSpec, raw: RawParams, size: "int | None" = None,
                        iters: int = 12, seed: int = 7, tol: float = 0.1,
                        device: "str | object" = "cuda", info: "dict | None" = None) -> RawParams:
    """Variance-equalized synthetic weights: the JAX package's
    ``equalize_raw_params`` on the port's forward.

    Plain He init compounds activation variance through deep stacks, so a
    synthetic yolov3 pins every head sigmoid at 1.0 and clamps every box to
    a border.  LSUV-style whole-net sweeps (Mishkin & Matas, arXiv
    1511.06422) fix that: each sweep refolds BN, runs one fp32 "highest"
    forward (TF32 off) of the probe input on ``device`` and reads every
    conv's post-activation output std ``s_i`` (population std), then walks
    the layers in order tracking the factor ``f`` by which each output will
    change, and divides each unbounded conv's kernel by ``s_i * f_in`` so its
    new output std lands near 1 given the rescaled upstream.  Routes take
    the geometric mean of their sources' factors, shortcuts the geometric
    mean of their two inputs', pools, upsamples and reorgs their input's.
    Logistic convs keep their kernels.  ``iters`` is a ceiling: a sweep
    stops first when every unbounded conv's ``|log s_i|`` is below ``tol``.

    The probe is numpy ``default_rng(seed).random((1, size, size, 3))``;
    ``size`` defaults to the smallest multiple of the deepest head stride
    (at least 32) not below 256.  One divergence from the JAX function: an
    unbounded conv whose std is too small to rescale (<= 1e-6) passes its
    input's factor on (``f_i = f_{i-1}``), since its kernel is unchanged
    and its output moves with its input; the JAX function uses 1.0 there.

    ``info``, when given, is filled with ``sweeps`` (rescaling sweeps
    taken), ``converged``, ``max_log_std`` (the largest ``|log s_i|``
    measured after the last sweep) and ``unscaled`` (the unbounded convs
    that took the small-std branch in some sweep).  Raises where
    ``device`` is CUDA and CUDA is absent."""
    import torch

    from .config import RouteSpec, ShortcutSpec, head_strides
    from .models.darknet import Darknet

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"equalize_raw_params on {device}, but torch.cuda.is_available() is "
                           "False: pass device='cpu' to equalize on the CPU")
    if size is None:
        mod = max(32, max(head_strides(spec)))
        size = max(mod, (256 + mod - 1) // mod * mod)
    x = torch.from_numpy(np.random.default_rng(seed).random((1, size, size, 3),
                                                            dtype=np.float32)).to(device)
    raw = {i: dict(e) for i, e in raw.items()}
    unbounded = {c.index for c in _conv_specs(spec) if c.activation != "logistic"}

    def measure() -> dict[int, float]:
        model = Darknet(spec, fold_batchnorm(spec, raw), precision="highest").to(device)
        _, stats = model(x, collect_conv_out_stats=lambda i, t: t.std(correction=0))
        idx = sorted(stats)
        vals = torch.stack([stats[i] for i in idx]).cpu().tolist()  # one copy a sweep
        return dict(zip(idx, vals))

    def max_log(s: dict[int, float]) -> float:
        devs = [abs(np.log(s[i])) for i in unbounded if s.get(i, 0.0) > 1e-6]
        return max(devs) if devs else 0.0

    sweeps, unscaled, converged, s = 0, set(), False, None
    for _ in range(iters):
        s = measure()
        if any(s.get(i, 0.0) > 1e-6 for i in unbounded) and max_log(s) < tol:
            converged = True
            break
        sweeps += 1
        f: dict[int, float] = {}
        src = lambda j: 1.0 if j < 0 else f[j]  # noqa: E731
        for layer in spec.layers:
            i = layer.index
            if isinstance(layer, ConvSpec):
                si = s.get(i, 0.0)
                if layer.activation == "logistic":
                    f[i] = 1.0  # bounded output: std ~input-invariant
                elif si > 1e-6:
                    raw[i]["w"] = (raw[i]["w"] / (si * src(i - 1))).astype(np.float32)
                    f[i] = 1.0 / si  # new output std ~1 against the measured si
                else:
                    unscaled.add(i)
                    f[i] = src(i - 1)  # kernel unchanged: the output moves with its input
            elif isinstance(layer, RouteSpec):
                f[i] = float(np.exp(np.mean([np.log(src(j)) for j in layer.layers])))
            elif isinstance(layer, ShortcutSpec):
                f[i] = float(np.sqrt(src(i - 1) * src(layer.from_layer)))
            else:  # pools, upsample, reorg, yolo/region: the input passes through
                f[i] = src(i - 1)
    if info is not None:
        if not converged:
            s = measure()
        info.update(sweeps=sweeps, converged=converged, max_log_std=float(max_log(s)),
                    unscaled=sorted(unscaled))
    return raw


def params_from_jax(params: Mapping[int, Mapping[str, np.ndarray]]) -> Params:
    """JAX package params ``{idx: {"w": HWIO, "b"}}`` -> ``{idx: {"w": OIHW, "b"}}``."""
    return {
        int(i): {"w": np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)),
                 "b": np.asarray(p["b"], np.float32)}
        for i, p in params.items()
    }
