"""The port's ``.weights`` writer, its native and numpy loaders, and the
package data, held to the JAX package's on the same files.

Tolerances: the writer's bytes are equal; the C++ loader's folded params
are within rtol 1e-6 / atol 1e-7 of numpy's (``tests/test_native.py``'s
bound for the JAX loader: the fold's fp32 rounding); the unfolded reads are
equal.
"""

import fnmatch
import os
import tomllib

import numpy as np
import pytest

import pytorch_yolo_tpu.weights as jw
import pytorch_yolo_tpu_torch as pt
import pytorch_yolo_tpu_torch.weights as tw
from pytorch_yolo_tpu.models.zoo import model_spec as jax_model_spec
from pytorch_yolo_tpu_torch import native
from pytorch_yolo_tpu_torch.ops import kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_params_close(ours, ref):
    assert set(ours) == set(ref)
    for i in ref:
        for key in ("w", "b"):
            np.testing.assert_allclose(ours[i][key], ref[i][key], rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """yolov3-tiny (both packages' specs), raw params, and the file the
    JAX writer makes of them."""
    spec, jspec = pt.model_spec("yolov3-tiny"), jax_model_spec("yolov3-tiny")
    path = str(tmp_path_factory.mktemp("wio") / "tiny.weights")
    jw.write_weights_file(jspec, jw.random_raw_params(jspec, seed=21), path, seen=777)
    return spec, jspec, tw.random_raw_params(spec, seed=21), path


@pytest.mark.parametrize("version,seen", [((0, 2, 0), 777), ((0, 1, 0), 5), ((1, 0, 3), 2**40)])
def test_write_weights_file_bytes_equal_jax(tmp_path, version, seen):
    """The same raw numbers (the port's OIHW, JAX's HWIO) give the same file,
    for the uint64 and the int32 "seen" headers; and it reads back."""
    if version[0] * 10 + version[1] < 2:
        seen = min(seen, 2**31 - 1)
    spec, jspec = pt.model_spec("yolov3-tiny"), jax_model_spec("yolov3-tiny")
    ours, ref = str(tmp_path / "t.weights"), str(tmp_path / "j.weights")
    raw = tw.random_raw_params(spec, seed=3)
    tw.write_weights_file(spec, raw, ours, seen=seen, version=version)
    jw.write_weights_file(jspec, jw.random_raw_params(jspec, seed=3), ref, seen=seen,
                          version=version)
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    back = tw.read_weights_file(spec, ours)
    for i, e in raw.items():
        for key, arr in e.items():
            np.testing.assert_array_equal(back[i][key], arr)


@pytest.mark.parametrize("native_flag", [False, True, None])
def test_load_weights_matches_jax(tiny, native_flag):
    """load_weights (folded) with native False / True / None equals JAX's
    load_weights on the same file, kernels laid out OIHW."""
    spec, jspec, _, path = tiny
    if native_flag is True:
        assert native.ensure_built() is not None, "g++ should build the loader here"
    ref = tw.params_from_jax(jw.load_weights(jspec, path, native=False))
    assert_params_close(tw.load_weights(spec, path, native=native_flag), ref)


def test_load_weights_unfolded_and_native_fold(tiny):
    """fold_bn=False returns the raw read; the C++ fold equals numpy's fold."""
    spec, _, raw, path = tiny
    unfolded = tw.load_weights(spec, path, fold_bn=False)
    for i, e in raw.items():
        for key, arr in e.items():
            np.testing.assert_array_equal(unfolded[i][key], arr)
    assert_params_close(tw.load_weights_native(spec, path), tw.fold_batchnorm(spec, raw))


def test_native_loader_rejects_bad_files(tiny, tmp_path, monkeypatch):
    """A truncated file raises WeightsError from the C++ loader; native=True
    raises where the library is unavailable, native=None falls back."""
    spec, jspec, _, path = tiny
    with open(path, "rb") as f:
        data = f.read()
    bad = str(tmp_path / "trunc.weights")
    with open(bad, "wb") as f:
        f.write(data[:-8])
    with pytest.raises(tw.WeightsError, match="size"):
        tw.load_weights_native(spec, bad)
    with pytest.raises(tw.WeightsError):
        tw.load_weights(spec, bad, native=False)
    monkeypatch.setattr(native, "load_library", lambda build=True: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tw.load_weights(spec, path, native=True)
    assert_params_close(tw.load_weights(spec, path),
                        tw.params_from_jax(jw.load_weights(jspec, path, native=False)))


def test_detector_load_with_weights_equals_numpy_path(tiny):
    """Detector.load(cfg, weights) now reads through load_weights; its
    params equal read_weights_file + fold_batchnorm, the path before."""
    spec, _, _, path = tiny
    det = pt.Detector.load("yolov3-tiny", path, device="cpu")
    assert det.weights_source == path
    assert_params_close(det._fp32_params, tw.fold_batchnorm(spec, tw.read_weights_file(spec, path)))


def test_package_data_covers_build_inputs():
    """Every kernel source and header the build reads, and the native
    loader's source, ships as package data; the native build directory is
    ignored by git."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    globs = project["tool"]["setuptools"]["package-data"]["pytorch_yolo_tpu_torch"]
    pkg = os.path.join(ROOT, "pytorch_yolo_tpu_torch")
    files = [*kernels.SOURCES, *kernels.HEADERS, native._SRC]
    assert len(files) == 14 and all(os.path.isfile(p) for p in files)
    for path in files:
        rel = os.path.relpath(path, pkg).replace(os.sep, "/")
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
    assert project["project"]["scripts"]["pytorch-yolo-tpu-torch"] == (
        "pytorch_yolo_tpu_torch.cli:main")
    with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as f:
        assert "pytorch_yolo_tpu_torch/native/_build/" in f.read().split()
