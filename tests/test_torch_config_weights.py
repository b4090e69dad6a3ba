"""The port's copies of the plain modules (cfg parser, weights IO, class
names) held equal to the JAX package's originals, exactly; and the port's
import boundary: no jax, no ``pytorch_yolo_tpu``."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.utils import names as jnames
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch import weights as tw
from pytorch_yolo_tpu_torch.utils import names as tnames
from tests.test_new_coords import MINI_CSP_CFG
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(ROOT, "cfg", "*.cfg")))


def _text(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _specs(text):
    return (jcfg.build_spec(jcfg.parse_cfg_text(text)),
            tcfg.build_spec(tcfg.parse_cfg_text(text)))


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_spec_equals_jax(path):
    jspec, tspec = _specs(_text(path))
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert [type(l).__name__ for l in tspec.layers] == [type(l).__name__ for l in jspec.layers]
    assert tcfg.head_strides(tspec) == jcfg.head_strides(jspec)
    assert tw.param_count(tspec) == jw.param_count(jspec)
    for size in (416, (384, 640)):
        assert tspec.num_detections(size) == jspec.num_detections(size)


@pytest.mark.parametrize("text", [
    "", "[net]\n[bogus]\n", "[net]\nwidth=32\n[convolutional]\nfilters=4\nsize=1\nactivation=swish\n",
    "[net]\n[route]\nlayers=-1\n", "[net\n", "width=32\n[net]\n",
    "[net]\n[convolutional]\nfilters=8\nsize=1\n[yolo]\nmask=0\nanchors=1,2\nclasses=80\n",
])
def test_config_errors_match_jax(text):
    with pytest.raises(jcfg.ConfigError) as jerr:
        jcfg.build_spec(jcfg.parse_cfg_text(text))
    with pytest.raises(tcfg.ConfigError) as terr:
        tcfg.build_spec(tcfg.parse_cfg_text(text))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov2-tiny", "yolov4-tiny", "yolov3"])
def test_random_raw_params_bit_identical(name):
    """Same seed, same numpy draws; the port lays kernels out OIHW."""
    jspec, tspec = _specs(_text(os.path.join(ROOT, "cfg", f"{name}.cfg")))
    jraw, traw = jw.random_raw_params(jspec, seed=5), tw.random_raw_params(tspec, seed=5)
    assert sorted(jraw) == sorted(traw)
    for i, je in jraw.items():
        assert sorted(je) == sorted(traw[i])
        np.testing.assert_array_equal(traw[i]["w"], je["w"].transpose(3, 2, 0, 1))
        for key in je:
            if key != "w":
                np.testing.assert_array_equal(traw[i][key], je[key])
                assert traw[i][key].dtype == np.float32


@pytest.mark.parametrize("text", [_text(os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")),
                                  MINI_CSP_CFG], ids=["yolov3-tiny", "mini-csp"])
def test_fold_batchnorm_and_params_from_jax(text):
    jspec, tspec = _specs(text)
    jfold = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=2))
    tfold = tw.fold_batchnorm(tspec, tw.random_raw_params(tspec, seed=2))
    conv = tw.params_from_jax(jfold)
    assert sorted(conv) == sorted(tfold)
    for i, p in tfold.items():
        np.testing.assert_array_equal(p["w"], jfold[i]["w"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(p["b"], jfold[i]["b"])
        np.testing.assert_array_equal(conv[i]["w"], p["w"])
        np.testing.assert_array_equal(conv[i]["b"], p["b"])
        assert conv[i]["w"].flags.c_contiguous
        # and back: OIHW -> HWIO restores the JAX array
        np.testing.assert_array_equal(conv[i]["w"].transpose(2, 3, 1, 0), jfold[i]["w"])


@pytest.mark.parametrize("version", [(0, 2, 0), (0, 1, 0)])
def test_weights_file_round_trip_from_jax_writer(tmp_path, version):
    jspec, tspec = _specs(_text(os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")))
    jraw = jw.random_raw_params(jspec, seed=9)
    path = str(tmp_path / "tiny.weights")
    jw.write_weights_file(jspec, jraw, path, version=version)
    traw = tw.read_weights_file(tspec, path)
    ref = tw.random_raw_params(tspec, seed=9)
    for i, e in ref.items():
        for key, arr in e.items():
            np.testing.assert_array_equal(traw[i][key], arr)
    with open(path, "rb") as f:
        data = f.read()
    for bad in (data[:8], data[:-4], data + b"\0\0\0\0", data[:-2]):
        with pytest.raises(tw.WeightsError):
            tw.read_weights_bytes(tspec, bad)
        with pytest.raises(jw.WeightsError):
            jw.read_weights_bytes(jspec, bad)


def test_class_names_match(tmp_path):
    assert tnames.COCO_NAMES == jnames.COCO_NAMES
    path = tmp_path / "x.names"
    path.write_text("cat\n\n dog \nbird\n", encoding="utf-8")
    assert tnames.load_classes(str(path)) == jnames.load_classes(str(path)) == ("cat", "dog", "bird")


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every module of the port pulls in
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pytorch_yolo_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'pytorch_yolo_tpu'))\n"
        "assert 'torch' in sys.modules and len(mods) >= 12, mods\n"
        "need = {'cli', 'eval', 'datasets', 'assets', 'native', 'utils.draw', 'utils.palette',\n"
        "        '__main__', 'parallel', 'parallel.sharding'}\n"
        "assert need <= {m.split('.', 1)[1] for m in mods}, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
