"""Native checkpoint store: the cfg text, the folded params and the class
names in one directory, so a later load skips ``.weights`` parsing and
BatchNorm folding.

The layout of ``pytorch_yolo_tpu/utils/checkpoint.py``, so that a
checkpoint written by either package loads in the other:

    <dir>/params/...    an Orbax pytree {"<layer>": {"w": HWIO, "b": ...}}
    <dir>/model.cfg     Darknet cfg text
    <dir>/meta.json     format version + class names

The port writes ``params/`` in Orbax's layout without OCDBT (one zarr v2
array directory a leaf, raw little-endian fp32 in one chunk, and the
``_METADATA`` tree description), with numpy alone; ``orbax.checkpoint``
restores it.  It reads that layout with numpy, and the OCDBT layout the
JAX package writes through ``tensorstore`` (which imports no jax) where it
is installed.  Kernels are HWIO in the file, as the JAX package holds
them; the port's OIHW params are transposed on the way out and in.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..config import ModelSpec, build_spec, parse_cfg_text
from ..weights import params_from_jax

FORMAT_VERSION = 1
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def _write_leaf(root: str, name: str, a: np.ndarray) -> None:
    """One zarr v2 array of a single uncompressed chunk."""
    a = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<"))
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    zarray = {"chunks": list(a.shape) or [1], "compressor": None, "dimension_separator": ".",
              "dtype": a.dtype.str, "fill_value": None, "filters": None, "order": "C",
              "shape": list(a.shape), "zarr_format": 2}
    with open(os.path.join(d, ".zarray"), "w", encoding="utf-8") as f:
        json.dump(zarray, f)
    with open(os.path.join(d, ".".join(["0"] * max(a.ndim, 1))), "wb") as f:
        f.write(a.tobytes())


def _write_tree(root: str, tree: "dict[str, dict[str, np.ndarray]]") -> None:
    os.makedirs(root, exist_ok=True)
    meta = {}
    for k, leaves in tree.items():
        for kk, a in leaves.items():
            _write_leaf(root, f"{k}.{kk}", a)
            meta[str((k, kk))] = {
                "key_metadata": [{"key": k, "key_type": 2}, {"key": kk, "key_type": 2}],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    with open(os.path.join(root, "_METADATA"), "w", encoding="utf-8") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(root, "_CHECKPOINT_METADATA"), "w", encoding="utf-8") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": 0, "commit_timestamp_nsecs": 0,
                   "custom_metadata": {}}, f)


def _read_leaf(root: str, name: str, ocdbt: bool) -> np.ndarray:
    d = os.path.join(root, name)
    if not ocdbt:
        with open(os.path.join(d, ".zarray"), "r", encoding="utf-8") as f:
            z = json.load(f)
        if z["compressor"] is None and z["chunks"] == (z["shape"] or [1]):
            with open(os.path.join(d, ".".join(["0"] * max(len(z["shape"]), 1))), "rb") as f:
                raw = f.read()
            order = "F" if z["order"] == "F" else "C"
            return np.frombuffer(raw, dtype=np.dtype(z["dtype"])).reshape(z["shape"],
                                                                          order=order).copy()
    try:
        import tensorstore as ts
    except ImportError:
        raise ImportError("this checkpoint's arrays are compressed or in OCDBT (the JAX "
                          "package's default); reading them needs the tensorstore package"
                          ) from None
    kv = ({"driver": "ocdbt", "base": "file://" + root + "/", "path": name} if ocdbt
          else {"driver": "file", "path": d + "/"})
    return np.asarray(ts.open({"driver": "zarr", "kvstore": kv}).result().read().result())


def _read_tree(root: str) -> "dict[str, dict[str, np.ndarray]]":
    with open(os.path.join(root, "_METADATA"), "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError("zarr3 checkpoints are not supported")
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        k, kk = (m["key"] for m in entry["key_metadata"])
        tree.setdefault(k, {})[kk] = _read_leaf(root, f"{k}.{kk}", bool(meta.get("use_ocdbt")))
    return tree


def save_checkpoint(path: str, cfg_text: str, params: dict,
                    class_names: "tuple[str, ...] | None" = None) -> None:
    """Persist cfg text + the port's folded params (OIHW kernels) to
    ``path`` (a directory)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.cfg"), "w", encoding="utf-8") as f:
        f.write(cfg_text)
    with open(os.path.join(path, "meta.json"), "w", encoding="utf-8") as f:
        json.dump({"format_version": FORMAT_VERSION,
                   "class_names": list(class_names) if class_names else None}, f)
    tree = {str(k): {kk: (np.asarray(vv).transpose(2, 3, 1, 0) if kk == "w"
                          else np.asarray(vv)) for kk, vv in v.items()}
            for k, v in params.items()}
    _write_tree(os.path.join(path, "params"), tree)


def load_checkpoint(path: str) -> "tuple[ModelSpec, str, dict, tuple[str, ...] | None]":
    """Load (spec, cfg_text, params with OIHW kernels, class_names) from a
    checkpoint directory written by either package."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "model.cfg"), "r", encoding="utf-8") as f:
        cfg_text = f.read()
    with open(os.path.join(path, "meta.json"), "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta['format_version']} is newer than "
                         f"supported {FORMAT_VERSION}")
    spec = build_spec(parse_cfg_text(cfg_text))
    tree = _read_tree(os.path.join(path, "params"))
    params = params_from_jax({int(k): dict(v) for k, v in tree.items()})
    names = meta.get("class_names")
    return spec, cfg_text, params, tuple(names) if names else None
