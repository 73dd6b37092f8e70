"""Torch7 ``.t7`` stylizers: the binary reader, the layer list, the exact
executor and the slot loader.

Port of ``neuralstyletransferv1_tpu/io/t7.py`` (the port keeps its own copy
of the numpy reader). The reference runs the legacy eccv16 / jcjohnson
Torch7 fast-style networks through OpenCV DNN (``readNetFromTorch``); here
the serialized Lua-Torch graph is parsed (``load_t7``), flattened into a
layer list (``build_t7_layers``: the JAX package's dicts, numpy HWIO
weights) and run by ``t7_apply`` in torch ops, the exact f32 executor of any
graph the list covers. ``io/t7_fast.py`` runs the graphs that match the
Johnson topology in the fast form.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_STORAGE_DTYPES = {
    "torch.DoubleStorage": np.float64,
    "torch.FloatStorage": np.float32,
    "torch.LongStorage": np.int64,
    "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16,
    "torch.CharStorage": np.int8,
    "torch.ByteStorage": np.uint8,
}


class TorchObject:
    """A deserialized Torch class instance (``torch.*`` / ``nn.*``)."""

    def __init__(self, typename: str, obj):
        self.torch_typename = typename
        self._obj = obj

    def __getattr__(self, k):
        try:
            return self._obj[k]
        except (KeyError, TypeError):
            raise AttributeError(k)

    def get(self, k, default=None):
        if isinstance(self._obj, dict):
            return self._obj.get(k, default)
        return default

    def __repr__(self):
        return f"TorchObject({self.torch_typename})"


class T7Reader:
    """The Torch7 binary serialization (``torch/File.c`` writeObject):
    little-endian, objects memoized by heap index."""

    def __init__(self, fh):
        self.f = fh
        self.memo: dict[int, object] = {}

    def _read(self, fmt, n):
        return struct.unpack(fmt, self.f.read(n))

    def read_int(self) -> int:
        return self._read("<i", 4)[0]

    def read_long(self) -> int:
        return self._read("<q", 8)[0]

    def read_double(self) -> float:
        return self._read("<d", 8)[0]

    def read_boolean(self) -> bool:
        return self.read_int() == 1

    def read_string(self) -> str:
        n = self.read_int()
        return self.f.read(n).decode("latin-1")

    def read_obj(self):
        typeidx = self.read_int()
        if typeidx == TYPE_NIL:
            return None
        if typeidx == TYPE_NUMBER:
            return self.read_double()
        if typeidx == TYPE_BOOLEAN:
            return self.read_boolean()
        if typeidx == TYPE_STRING:
            return self.read_string()
        if typeidx in (TYPE_TABLE, TYPE_TORCH, TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                       TYPE_LEGACY_RECUR_FUNCTION):
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            if typeidx in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
                size = self.read_int()
                self.f.read(size)  # dumped bytecode, ignored
                obj = ("function", self.read_obj())
                self.memo[index] = obj
                return obj
            if typeidx == TYPE_TORCH:
                version = self.read_string()
                typename = self.read_string() if version.startswith("V ") else version
                return self._read_torch_object(typename, index)
            size = self.read_int()
            table: dict = {}
            self.memo[index] = table
            for _ in range(size):
                k = self.read_obj()
                table[k] = self.read_obj()
            return table
        raise ValueError(f"unknown T7 type id {typeidx}")

    def _read_torch_object(self, typename: str, index: int):
        if typename in _STORAGE_DTYPES:
            dtype = _STORAGE_DTYPES[typename]
            size = self.read_long()
            data = np.frombuffer(self.f.read(size * np.dtype(dtype).itemsize), dtype=dtype)
            self.memo[index] = data
            return data
        if typename.endswith("Tensor"):
            ndim = self.read_int()
            shape = self._read("<%dq" % ndim, 8 * ndim) if ndim else ()
            strides = self._read("<%dq" % ndim, 8 * ndim) if ndim else ()
            offset = self.read_long() - 1
            self.memo[index] = {}
            storage = self.read_obj()
            if storage is None or ndim == 0:
                arr = np.zeros(shape or (0,), np.float32)
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:], shape=shape,
                    strides=[s * storage.dtype.itemsize for s in strides]).copy()
            self.memo[index] = arr
            return arr
        # a generic nn.* class: its state is one serialized table
        obj = TorchObject(typename, {})
        self.memo[index] = obj
        state = self.read_obj()
        obj._obj = state if state is not None else {}
        return obj


def load_t7(path: str):
    """Deserialize a binary .t7 file into python / numpy objects."""
    with open(path, "rb") as fh:
        return T7Reader(fh).read_obj()


def _modules(seq: TorchObject):
    mods = seq.get("modules", {})
    if isinstance(mods, dict):
        return [mods[k] for k in sorted(mods, key=lambda x: float(x))]
    return list(mods)


def _f32(mod: TorchObject, key: str):
    v = mod.get(key)
    return None if v is None else np.asarray(v, np.float32)


def build_t7_layers(net: TorchObject) -> list[dict]:
    """Flatten a deserialized Lua-nn graph into the layer list ``t7_apply``
    runs (the JAX package's dicts: conv weights HWIO, transposed-conv
    weights [kh,kw,Cout,Cin]). Raises on unsupported module types."""
    layers: list[dict] = []

    def sub(mod) -> list[dict]:
        saved = layers[:]
        del layers[:]
        walk(mod)
        out = layers[:]
        layers[:] = saved
        return out

    def walk(mod):
        t = mod.torch_typename
        if t == "nn.Sequential":
            for m in _modules(mod):
                walk(m)
        elif t == "nn.ConcatTable":
            layers.append({"op": "concat_table", "branches": [sub(m) for m in _modules(mod)]})
        elif t == "nn.CAddTable":
            layers.append({"op": "add_table"})
        elif t == "nn.SpatialConvolution":
            layers.append({"op": "conv",
                           "w": np.transpose(np.asarray(mod.weight, np.float32), (2, 3, 1, 0)),
                           "b": _f32(mod, "bias"),
                           "stride": (int(mod.get("dH", 1)), int(mod.get("dW", 1))),
                           "pad": (int(mod.get("padH", 0)), int(mod.get("padW", 0)))})
        elif t == "nn.SpatialFullConvolution":
            layers.append({"op": "conv_transpose",
                           "w": np.transpose(np.asarray(mod.weight, np.float32), (2, 3, 1, 0)),
                           "b": _f32(mod, "bias"), "stride": int(mod.get("dH", 1)),
                           "pad": int(mod.get("padH", 0)), "adj": int(mod.get("adjH", 0))})
        elif t in ("nn.SpatialBatchNormalization", "nn.InstanceNormalization"):
            layers.append({"op": "batchnorm" if t == "nn.SpatialBatchNormalization"
                           else "instancenorm",
                           "weight": _f32(mod, "weight"), "bias": _f32(mod, "bias"),
                           "running_mean": _f32(mod, "running_mean"),
                           "running_var": _f32(mod, "running_var"),
                           "eps": float(mod.get("eps", 1e-5))})
        elif t in ("nn.SpatialReflectionPadding", "nn.SpatialZeroPadding"):
            layers.append({"op": "reflect_pad" if t == "nn.SpatialReflectionPadding"
                           else "zero_pad", "pad": int(mod.get("pad_t", mod.get("pad_l", 0)))})
        elif t == "nn.ReLU":
            layers.append({"op": "relu"})
        elif t == "nn.Tanh":
            layers.append({"op": "tanh"})
        elif t == "nn.MulConstant":
            layers.append({"op": "mul", "c": float(mod.get("constant_scalar", 1.0))})
        elif t == "nn.SpatialUpSamplingNearest":
            layers.append({"op": "upsample", "factor": int(mod.get("scale_factor", 2))})
        elif t not in ("nn.Identity", "nn.TotalVariation"):
            raise NotImplementedError(f"t7 module not supported: {t}")

    walk(net)
    return layers


def _t(a, like: torch.Tensor) -> torch.Tensor:
    """A layer parameter (numpy or torch) on ``like``'s device and dtype."""
    return torch.as_tensor(a, device=like.device).to(like.dtype)


def _nchw(f, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    return f(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def t7_apply(layers: list[dict], x: torch.Tensor) -> torch.Tensor:
    """Run a ``build_t7_layers`` list on an NHWC batch, in x's dtype (the
    parameters are cast to it). f32 is the exact executor: instance norms
    take f32 statistics whatever the dtype, as the JAX executor's do."""
    from ..ops.norm import instance_norm
    from ..ops.pad import reflect_pad_2d
    from ..ops.resize import upsample_nearest

    pending = None
    for l in layers:
        op = l["op"]
        if op == "conv":
            b = None if l["b"] is None else _t(l["b"], x)
            x = _nchw(F.conv2d, x, _t(l["w"], x).permute(3, 2, 0, 1), b,
                      stride=l["stride"], padding=l["pad"])
        elif op == "conv_transpose":
            b = None if l["b"] is None else _t(l["b"], x)
            x = _nchw(F.conv_transpose2d, x, _t(l["w"], x).permute(3, 2, 0, 1), b,
                      stride=l["stride"], padding=l["pad"], output_padding=l["adj"])
        elif op == "batchnorm":
            mean = 0.0 if l["running_mean"] is None else _t(l["running_mean"], x)
            var = 1.0 if l["running_var"] is None else _t(l["running_var"], x)
            y = (x - mean) * torch.rsqrt(torch.as_tensor(var + l["eps"], dtype=x.dtype,
                                                         device=x.device))
            if l["weight"] is not None:
                y = y * _t(l["weight"], x)
            if l["bias"] is not None:
                y = y + _t(l["bias"], x)
            x = y
        elif op == "instancenorm":
            c = x.shape[-1]
            ones, zeros = torch.ones(c, device=x.device), torch.zeros(c, device=x.device)
            x = instance_norm(x, ones if l["weight"] is None else _t(l["weight"], x),
                              zeros if l["bias"] is None else _t(l["bias"], x), eps=l["eps"])
        elif op == "reflect_pad":
            x = reflect_pad_2d(x, l["pad"])
        elif op == "zero_pad":
            p = l["pad"]
            x = F.pad(x, (0, 0, p, p, p, p))
        elif op == "relu":
            x = torch.relu(x)
        elif op == "tanh":
            x = torch.tanh(x)
        elif op == "mul":
            x = x * l["c"]
        elif op == "upsample":
            x = upsample_nearest(x, l["factor"])
        elif op == "concat_table":
            pending = [t7_apply(br, x) for br in l["branches"]]
        elif op == "add_table":
            # consumes the preceding ConcatTable's branch outputs
            x = pending[0]
            for o in pending[1:]:
                x = x + o
            pending = None
        else:
            raise ValueError(op)
    return x


def tree_map(fn, v):
    """``fn`` over the arrays (numpy or tensors) of a tree of dicts and lists
    (a layer list, or the fast form's params); python values stay."""
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return fn(v)
    if isinstance(v, dict):
        return {k: tree_map(fn, e) for k, e in v.items()}
    if isinstance(v, list):
        return [tree_map(fn, e) for e in v]
    return v


def layers_to(layers: list[dict], device, dtype: torch.dtype) -> list[dict]:
    """The layer list with every array a ``dtype`` tensor on ``device`` (a
    slot's resident copy; ``t7_apply`` then casts nothing)."""
    return tree_map(lambda a: torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                                              else a).to(device, dtype), layers)


def layers_device(layers: list[dict]) -> torch.device:
    """The device of a slot's layer list: its first tensor's (the CPU for a
    list of numpy arrays)."""
    found = []
    tree_map(found.append, layers)
    return next((a.device for a in found if isinstance(a, torch.Tensor)), torch.device("cpu"))


def load_torch7_model(path: str, io_preset: str = "auto", device="cpu"):
    """A ``.t7`` stylizer as a slot: arch ``t7``, the layer list as f32
    tensors on ``device``, preset ``auto`` → ``caffe_bgr``."""
    from ..engine.stylizer import StyleModel

    net = load_t7(path)
    if not isinstance(net, TorchObject):
        raise ValueError(f"{path}: not a torch nn module")
    layers = layers_to(build_t7_layers(net), device, torch.float32)
    if io_preset == "auto":
        io_preset = "caffe_bgr"
    return StyleModel("t7", layers, io_preset, Path(path).stem)
