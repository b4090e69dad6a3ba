"""Darknet ``.cfg`` parsing into an immutable model spec.

A copy of ``pytorch_yolo_tpu/config.py``: importing the JAX package's
module would import jax (its ``__init__`` pulls in the API), and this
package must run where jax is absent.  ``tests/test_torch_config_weights.py``
holds the two parsers equal on every cfg in ``cfg/``.

The Darknet ``.cfg`` format is the reference's model-definition language
(reference: Dipet/pytorch_yolo cfg parser; see SURVEY.md §5.6 for the format
specification and §2.1 #1-2 for the parser/builder components this replaces).
Unlike the reference — which walks the parsed blocks to build a mutable
``nn.ModuleList`` — we compile the blocks into a tuple of frozen
:class:`LayerSpec` dataclasses.  The spec is pure data: hashable, static under
``jax.jit`` tracing, and independent of any parameter storage.  Model topology
(route/shortcut wiring) is resolved **once** here, at parse time, into
absolute layer indices, so the functional forward pass in
``models/darknet.py`` is a straight-line traversal with no index arithmetic
at trace time.

Format summary (SURVEY.md §5.6, [B]-tier stable public format):

    [net]            batch, width, height, channels, ... (training keys ignored)
    [convolutional]  batch_normalize=0|1, filters, size, stride, pad,
                     activation=leaky|linear
    [shortcut]       from=-3, activation=linear     # residual add
    [route]          layers=-4  or  layers=-1, 61   # channel concat
    [upsample]       stride=2
    [maxpool]        size, stride                   # incl. size=2,stride=1 quirk
    [yolo]           mask, anchors, classes, num    # detection head
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


class ConfigError(ValueError):
    """Raised for malformed or unsupported .cfg content."""


# ---------------------------------------------------------------------------
# Frozen layer specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetInfo:
    """The ``[net]`` block hyperparameters we honor (rest are training-only)."""

    width: int = 416
    height: int = 416
    channels: int = 3


CONV_ACTIVATIONS = ("leaky", "linear", "mish", "relu", "logistic")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """``[convolutional]``: conv (+BN) (+activation).

    Activations: ``leaky`` (slope 0.1) / ``linear`` (YOLOv2/v3 family),
    ``mish`` (x * tanh(softplus(x)), the YOLOv4 CSP backbone activation),
    ``relu`` (appears in some Darknet classifier cfgs) and ``logistic``
    (element-wise sigmoid — Scaled-YOLOv4/yolov4-csp head convs, paired
    with ``[yolo] new_coords=1``)."""

    index: int
    in_channels: int
    filters: int
    size: int
    stride: int
    pad: int  # darknet pad flag: actual padding = size // 2 if pad else 0
    batch_normalize: bool
    activation: str  # one of CONV_ACTIVATIONS

    @property
    def padding(self) -> int:
        return self.size // 2 if self.pad else 0


@dataclasses.dataclass(frozen=True)
class MaxPoolSpec:
    """``[maxpool]``.  Darknet semantics: output = ceil(in / stride); for the
    tiny-YOLOv3 size=2,stride=1 layer this needs asymmetric (0,1) trailing pad
    with -inf fill to preserve 13x13 (SURVEY.md §7 hard parts)."""

    index: int
    size: int
    stride: int


@dataclasses.dataclass(frozen=True)
class UpsampleSpec:
    """``[upsample]``: nearest-neighbor x``stride``."""

    index: int
    stride: int


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """``[route]``: channel concat of one or more earlier layers.

    ``layers`` hold absolute indices (negatives already resolved).

    ``groups``/``group_id`` implement the YOLOv4-tiny CSP split: each
    source layer contributes only its ``group_id``-th of ``groups`` equal
    channel slices (Darknet's route_layer copies
    ``input_size/groups`` floats from offset ``group_id * part`` per
    input).  The common case is a single-source split route
    (``layers=-1, groups=2, group_id=1``)."""

    index: int
    layers: tuple[int, ...]
    groups: int = 1
    group_id: int = 0


@dataclasses.dataclass(frozen=True)
class ShortcutSpec:
    """``[shortcut]``: elementwise residual add with layer ``from_layer``
    (absolute index) and the immediately preceding layer."""

    index: int
    from_layer: int
    activation: str = "linear"


@dataclasses.dataclass(frozen=True)
class ReorgSpec:
    """``[reorg]``: YOLOv2 passthrough layer, (H, W, C) -> (H/s, W/s, C*s²).

    Darknet's reorg is NOT a plain space-to-depth: its C implementation
    flat-reinterprets the NCHW input buffer as (C/s², H*s, W*s), gathers with
    stride-interleaved offsets, and the (C, H, W)-indexed result is consumed
    downstream as (C*s², H/s, W/s).  Upstream yolov2 weights were trained
    against exactly that shuffle, so we reproduce it bit-for-bit
    (models/darknet.py:_reorg; oracle: tests/oracle/torch_ref.py)."""

    index: int
    stride: int


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """``[region]`` detection head (YOLOv2).

    Differences from ``[yolo]`` (SURVEY.md §2.1 #5 documents the v3 head):
    ``anchors`` are in *grid-cell units* (scaled by the head stride at decode
    time), there is no mask (all ``num`` anchors are live at the single
    scale), and class scores use a softmax over classes instead of
    independent sigmoids (when ``softmax=1``; raw logits otherwise,
    matching Darknet's region_layer)."""

    index: int
    anchors: tuple[tuple[float, float], ...]  # grid-cell units
    classes: int
    num: int
    softmax: bool = True


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """``[yolo]`` detection head.

    ``anchors`` are the mask-selected (w, h) pairs in net-input pixels.

    ``scale_x_y`` (YOLOv4, "grid sensitivity" — arXiv 2004.10934 §3.3)
    widens the sigmoid center offsets:
    ``bx = (scale * sigmoid(tx) - 0.5 * (scale - 1) + cx) * stride``;
    the YOLOv3 family leaves it at 1.0 (plain ``sigmoid(tx) + cx``).

    ``new_coords`` (Scaled-YOLOv4 / yolov4-csp dialect, arXiv 2011.08036):
    the preceding conv carries ``activation=logistic`` over ALL channels,
    so the head receives already-activated values and decodes WITHOUT its
    own sigmoid/exp: ``bx = (tx * scale - 0.5 * (scale - 1) + cx) * stride``,
    ``bw = (2 * tw)^2 * pw``, obj/class scores pass through."""

    index: int
    anchors: tuple[tuple[float, float], ...]
    classes: int
    all_anchors: tuple[tuple[float, float], ...]
    mask: tuple[int, ...]
    scale_x_y: float = 1.0
    new_coords: bool = False


LayerSpec = (ConvSpec | MaxPoolSpec | UpsampleSpec | RouteSpec | ShortcutSpec
             | ReorgSpec | RegionSpec | YoloSpec)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Complete parsed model: net hyperparams + ordered layer tuple.

    ``out_channels[i]`` is the channel count of layer ``i``'s output —
    precomputed here so downstream code never re-derives route/shortcut
    arity (the reference tracks this with ``prev_filters``/``output_filters``
    bookkeeping inside its module builder; SURVEY.md §3.1)."""

    net: NetInfo
    layers: tuple[LayerSpec, ...]
    out_channels: tuple[int, ...]

    @property
    def yolo_layers(self) -> "tuple[YoloSpec | RegionSpec, ...]":
        """All detection heads, [yolo] (v3) and [region] (v2) alike."""
        return tuple(l for l in self.layers if isinstance(l, (YoloSpec, RegionSpec)))

    @property
    def num_classes(self) -> int:
        heads = self.yolo_layers
        if not heads:
            raise ConfigError("model has no [yolo] layers")
        return heads[0].classes

    def num_detections(self, input_size: "int | tuple[int, int]") -> int:
        """Total anchor boxes D for a given input size (square int or (H, W)).

        For full YOLOv3 at 416: 10647; tiny at 416: 2535 (SURVEY.md §3.3)."""
        sh, sw = ((input_size, input_size) if isinstance(input_size, int)
                  else input_size)
        total = 0
        strides = head_strides(self)
        for head, stride in zip(self.yolo_layers, strides):
            total += len(head.anchors) * (sh // stride) * (sw // stride)
        return total


# ---------------------------------------------------------------------------
# Tokenizer: .cfg text → ordered list of {type, key: value} blocks
# ---------------------------------------------------------------------------


def parse_cfg_text(text: str) -> list[dict[str, str]]:
    """Tokenize Darknet cfg text into an ordered list of blocks.

    Each block is a dict with a ``"type"`` key plus raw string key/values.
    Comments (``#`` / ``;``) and blank lines are ignored; whitespace around
    ``=`` is tolerated.  Duplicate keys within a block keep the last value
    (Darknet behavior)."""
    blocks: list[dict[str, str]] = []
    current: dict[str, str] | None = None
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith(("#", ";")):
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise ConfigError(f"line {lineno}: malformed section header {line!r}")
            current = {"type": line[1:-1].strip().lower()}
            blocks.append(current)
            continue
        if current is None:
            raise ConfigError(f"line {lineno}: key/value before any [section]")
        if "=" not in line:
            raise ConfigError(f"line {lineno}: expected key=value, got {line!r}")
        key, _, value = line.partition("=")
        current[key.strip()] = value.strip()
    if not blocks:
        raise ConfigError("empty cfg")
    return blocks


def parse_cfg_file(path: str) -> list[dict[str, str]]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_cfg_text(f.read())


# ---------------------------------------------------------------------------
# Block list → ModelSpec
# ---------------------------------------------------------------------------


def _int(block: Mapping[str, str], key: str, default: int | None = None) -> int:
    if key not in block:
        if default is None:
            raise ConfigError(f"[{block['type']}] missing required key {key!r}")
        return default
    return int(block[key])


def _resolve(ref: int, index: int) -> int:
    """Resolve a possibly-negative layer reference to an absolute index."""
    abs_idx = index + ref if ref < 0 else ref
    if not 0 <= abs_idx < index:
        raise ConfigError(f"layer {index}: reference {ref} resolves out of range")
    return abs_idx


def build_spec(blocks: Sequence[Mapping[str, str]]) -> ModelSpec:
    """Compile parsed blocks into a frozen :class:`ModelSpec`.

    Mirrors the behavioral contract of the reference's ``create_modules``
    (SURVEY.md §3.1) but resolves all topology statically instead of
    deferring route/shortcut to forward time."""
    if blocks[0]["type"] not in ("net", "network"):
        raise ConfigError("first block must be [net]")
    netb = blocks[0]
    net = NetInfo(
        width=_int(netb, "width", 416),
        height=_int(netb, "height", 416),
        channels=_int(netb, "channels", 3),
    )

    layers: list[LayerSpec] = []
    out_ch: list[int] = []
    prev_ch = net.channels

    for i, block in enumerate(blocks[1:]):
        btype = block["type"]
        if btype == "convolutional":
            bn = bool(_int(block, "batch_normalize", 0))
            spec = ConvSpec(
                index=i,
                in_channels=prev_ch,
                filters=_int(block, "filters"),
                size=_int(block, "size"),
                stride=_int(block, "stride", 1),
                pad=_int(block, "pad", 0),
                batch_normalize=bn,
                activation=block.get("activation", "linear"),
            )
            if spec.activation not in CONV_ACTIVATIONS:
                raise ConfigError(f"layer {i}: unsupported activation {spec.activation!r}")
            ch = spec.filters
        elif btype == "maxpool":
            spec = MaxPoolSpec(index=i, size=_int(block, "size", 2), stride=_int(block, "stride", 2))
            ch = prev_ch
        elif btype == "upsample":
            spec = UpsampleSpec(index=i, stride=_int(block, "stride", 2))
            ch = prev_ch
        elif btype == "route":
            refs = tuple(int(tok) for tok in block["layers"].replace(" ", "").split(",") if tok)
            resolved = tuple(_resolve(r, i) for r in refs)
            groups = _int(block, "groups", 1)
            group_id = _int(block, "group_id", 0)
            if groups < 1 or not 0 <= group_id < groups:
                raise ConfigError(
                    f"layer {i}: route group_id={group_id} out of range for "
                    f"groups={groups}")
            for j in resolved:
                if out_ch[j] % groups:
                    raise ConfigError(
                        f"layer {i}: route source {j} has {out_ch[j]} channels, "
                        f"not divisible by groups={groups}")
            spec = RouteSpec(index=i, layers=resolved, groups=groups,
                             group_id=group_id)
            ch = sum(out_ch[j] // groups for j in resolved)
        elif btype == "shortcut":
            frm = _resolve(_int(block, "from"), i)
            spec = ShortcutSpec(index=i, from_layer=frm, activation=block.get("activation", "linear"))
            if out_ch[frm] != prev_ch:
                raise ConfigError(
                    f"layer {i}: shortcut channel mismatch {out_ch[frm]} vs {prev_ch}"
                )
            ch = prev_ch
        elif btype == "reorg":
            s = _int(block, "stride", 2)
            if _int(block, "reverse", 0):
                raise ConfigError(f"layer {i}: [reorg] reverse=1 is unsupported")
            if s < 1 or prev_ch % (s * s):
                raise ConfigError(
                    f"layer {i}: reorg stride {s} incompatible with {prev_ch} channels")
            spec = ReorgSpec(index=i, stride=s)
            ch = prev_ch * s * s
        elif btype == "region":
            flat = [float(t) for t in block["anchors"].replace(" ", "").split(",") if t]
            if len(flat) % 2:
                raise ConfigError(f"layer {i}: odd anchor list")
            pairs = tuple((flat[j], flat[j + 1]) for j in range(0, len(flat), 2))
            num = _int(block, "num", len(pairs))
            if num != len(pairs):
                raise ConfigError(
                    f"layer {i}: [region] num={num} but {len(pairs)} anchors given")
            spec = RegionSpec(
                index=i,
                anchors=pairs,
                classes=_int(block, "classes", 20),
                num=num,
                softmax=bool(_int(block, "softmax", 1)),
            )
            ch = prev_ch
        elif btype == "yolo":
            mask = tuple(int(t) for t in block["mask"].replace(" ", "").split(",") if t)
            flat = [float(t) for t in block["anchors"].replace(" ", "").split(",") if t]
            if len(flat) % 2:
                raise ConfigError(f"layer {i}: odd anchor list")
            pairs = tuple((flat[j], flat[j + 1]) for j in range(0, len(flat), 2))
            for m in mask:
                if m >= len(pairs):
                    raise ConfigError(f"layer {i}: mask {m} out of range for {len(pairs)} anchors")
            spec = YoloSpec(
                index=i,
                anchors=tuple(pairs[m] for m in mask),
                classes=_int(block, "classes", 80),
                all_anchors=pairs,
                mask=mask,
                scale_x_y=float(block.get("scale_x_y", 1.0)),
                new_coords=bool(int(block.get("new_coords", 0))),
            )
            ch = prev_ch
        else:
            raise ConfigError(f"layer {i}: unsupported block type [{btype}]")
        layers.append(spec)
        out_ch.append(ch)
        prev_ch = ch

    spec = ModelSpec(net=net, layers=tuple(layers), out_channels=tuple(out_ch))
    # Sanity: every detection head must follow a conv producing A*(5+C).
    for head in spec.yolo_layers:
        need = len(head.anchors) * (5 + head.classes)
        got = spec.out_channels[head.index - 1]
        if got != need:
            raise ConfigError(
                f"yolo layer {head.index}: preceding conv has {got} channels, expected {need}"
            )
    return spec


def load_model_spec(path: str) -> ModelSpec:
    """One-call ``.cfg`` file → :class:`ModelSpec`."""
    return build_spec(parse_cfg_file(path))


def head_strides(spec: ModelSpec) -> tuple[int, ...]:
    """Network stride at each [yolo] head, derived by walking spatial scaling.

    Conv/maxpool with stride s multiply the cumulative stride by s; upsample
    divides it; route resets it to the (common) stride of its sources."""
    stride_at: list[int] = []
    cur = 1
    for layer in spec.layers:
        if isinstance(layer, ConvSpec):
            cur = cur * layer.stride
        elif isinstance(layer, (MaxPoolSpec, ReorgSpec)):
            cur = cur * layer.stride
        elif isinstance(layer, UpsampleSpec):
            cur = cur // layer.stride
        elif isinstance(layer, RouteSpec):
            cur = stride_at[layer.layers[0]]
        elif isinstance(layer, ShortcutSpec):
            cur = stride_at[layer.index - 1]
        stride_at.append(cur)
    return tuple(stride_at[h.index] for h in spec.yolo_layers)
