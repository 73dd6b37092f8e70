"""TF SavedModel → PyTorch: the variable reader and a GraphDef executor.

Counterpart of ``neuralstyletransferv1_tpu/io/tf_saved_model.py``, which
runs the magenta slot's TF-Hub SavedModel (``arbitrary-image-stylization
-v1-256/2``) without the TF runtime. ``tensorflow`` is only the reader of
the protobufs and the checkpoint, imported inside the functions that read;
the function graph is evaluated op by op in torch on the variables' device.

Tensors stay NHWC between ops, so ``ConcatV2``, ``Mean``, ``Squeeze`` and
``ExpandDims`` read the graph's own axes. ``Shape``, ``StridedSlice``,
``Pack`` and a ``Mul`` of host values stay numpy on the host, so sizes stay
Python integers. As in the JAX executor: ``SAME`` padding is TF's (the odd
cell after, at stride 2 too), ``AvgPool`` divides by the valid cells,
``MirrorPad`` reflects whatever its mode attribute says, and
``ResizeNearestNeighbor`` is TF's legacy floor index.

Checkpoint keys: the TF2 object graph numbers variables
(``variables/N/.ATTRIBUTES/VARIABLE_VALUE``); the SavedModel's
``object_graph_def`` maps each to its semantic name
(``transformer/contract/conv1/weights``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def load_saved_model_proto(model_dir: str | Path):
    from tensorflow.core.protobuf import saved_model_pb2

    sm = saved_model_pb2.SavedModel()
    sm.ParseFromString((Path(model_dir) / "saved_model.pb").read_bytes())
    return sm.meta_graphs[0]


def checkpoint_name_map(meta_graph) -> dict[str, str]:
    """Checkpoint key → semantic variable name, from ``object_graph_def``."""
    og = meta_graph.object_graph_def
    out = {}

    def walk(idx, path):
        node = og.nodes[idx]
        if node.WhichOneof("kind") == "variable":
            out[f"{path}/.ATTRIBUTES/VARIABLE_VALUE"] = node.variable.name
        for child in node.children:
            walk(child.node_id, (path + "/" if path else "") + child.local_name)

    walk(0, "")
    return out


def load_variables(model_dir: str | Path) -> dict[str, np.ndarray]:
    """Semantic name → array, from the SavedModel's checkpoint."""
    import tensorflow as tf

    name_map = checkpoint_name_map(load_saved_model_proto(model_dir))
    rdr = tf.train.load_checkpoint(str(Path(model_dir) / "variables" / "variables"))
    return {semantic: np.asarray(rdr.get_tensor(key)) for key, semantic in name_map.items()}


def _const_ndarray(node) -> np.ndarray:
    from tensorflow.python.framework import tensor_util

    return tensor_util.MakeNdarray(node.attr["value"].tensor)


def _resolve_call_chain(meta_graph):
    """The serving function and the outer graph's source of each of its
    arguments (placeholder or variable name), through the outer
    ``StatefulPartitionedCall`` and the signature wrappers."""
    gd = meta_graph.graph_def
    funcs = {f.signature.name: f for f in gd.library.function}
    outer_call = next(n for n in gd.node if n.op == "StatefulPartitionedCall")
    outer_inputs = [i.split(":")[0] for i in outer_call.input]
    fn = funcs[outer_call.attr["f"].func.name]
    while True:  # descend through wrapper calls to the function with the compute
        calls = [n for n in fn.node_def if n.op == "StatefulPartitionedCall"]
        if len(calls) != 1 or len(fn.node_def) > 4:
            break
        call = calls[0]
        pos = {a.name: i for i, a in enumerate(fn.signature.input_arg)}
        outer_inputs = [outer_inputs[pos[i.split(":")[0]]] for i in call.input]
        fn = funcs[call.attr["f"].func.name]
    return fn, outer_inputs


def _ref_node(ref: str) -> str:
    return ref.split(":")[0]


def _is_host(v) -> bool:
    return isinstance(v, np.ndarray) or np.isscalar(v)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF's SAME padding of one axis: (before, after), the odd cell after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _window_pads(x: torch.Tensor, k: tuple, s: tuple, padding: str) -> tuple:
    """F.pad's (left, right, top, bottom) for an NCHW tensor."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding != "SAME":
        raise NotImplementedError(f"padding {padding}")
    (t, b), (le, r) = _same_pads(x.shape[2], k[0], s[0]), _same_pads(x.shape[3], k[1], s[1])
    return (le, r, t, b)


def _reflect_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """np.pad(mode="reflect") over every axis of ``x``."""
    for dim, (a, b) in enumerate(pads):
        a, b = int(a), int(b)
        if a or b:
            n = x.shape[dim]
            idx = list(range(a, 0, -1)) + list(range(n)) + list(range(n - 2, n - 2 - b, -1))
            x = x.index_select(dim, torch.tensor(idx, device=x.device))
    return x


class TFGraphExecutor:
    """Executor of a SavedModel's serving function, its variables as torch
    tensors on ``device``."""

    def __init__(self, model_dir: str | Path, variables: dict[str, np.ndarray] | None = None,
                 device: torch.device | str = "cpu"):
        mg = load_saved_model_proto(model_dir)
        self.fn, self.arg_sources = _resolve_call_chain(mg)
        self.device = torch.device(device)
        variables = variables if variables is not None else load_variables(model_dir)
        self.variables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                          for k, v in variables.items() if np.asarray(v).dtype != object}
        gd_nodes = {n.name: n for n in mg.graph_def.node}
        self.placeholder_args = [
            i for i, src in enumerate(self.arg_sources)
            if gd_nodes.get(src) is not None and gd_nodes[src].op == "Placeholder"]
        self.output_refs = dict(self.fn.ret)
        self.consts = {n.name: _const_ndarray(n) for n in self.fn.node_def if n.op == "Const"}

    def _dev(self, v):
        """A host value as a tensor on the executor's device."""
        return torch.as_tensor(v, device=self.device) if _is_host(v) else v

    def _run(self, placeholders: dict[int, torch.Tensor]) -> dict:
        """Evaluate the function graph; returns {ret name: value}."""
        env: dict[str, object] = {}
        arg_names = [a.name for a in self.fn.signature.input_arg]
        for i, (arg, src) in enumerate(zip(arg_names, self.arg_sources)):
            env[arg] = placeholders[i] if i in placeholders else self.variables[src]
        for node in self.fn.node_def:
            env[node.name] = self._op(node, [env[_ref_node(i)] for i in node.input
                                             if not i.startswith("^")])
        return {ret: env[_ref_node(src)] for ret, src in self.output_refs.items()}

    def _op(self, node, ins):
        op, d = node.op, self._dev
        if op == "Const":
            return self.consts[node.name]
        if op in ("Identity", "CheckNumerics", "StopGradient", "ReadVariableOp"):
            return ins[0]
        if op == "NoOp":
            return None
        if op == "Conv2D":
            s = list(node.attr["strides"].list.i)[1:3]
            w = d(ins[1]).permute(3, 2, 0, 1)
            x = d(ins[0]).permute(0, 3, 1, 2)
            x = F.pad(x, _window_pads(x, w.shape[2:], s, node.attr["padding"].s.decode()))
            return F.conv2d(x, w, stride=s).permute(0, 2, 3, 1)
        if op == "FusedBatchNormV3":
            x, scale, offset, mean, var = (d(v) for v in ins[:5])
            return (x - mean) * torch.rsqrt(var + node.attr["epsilon"].f) * scale + offset
        if op in ("BiasAdd", "AddV2"):
            return d(ins[0]) + d(ins[1])
        if op == "Sub":
            return d(ins[0]) - d(ins[1])
        if op == "Mul":
            if all(_is_host(v) for v in ins):
                return np.multiply(ins[0], ins[1])
            return d(ins[0]) * d(ins[1])
        if op == "Relu":
            return F.relu(ins[0])
        if op == "Relu6":
            return ins[0].clamp(0.0, 6.0)
        if op == "Sigmoid":
            return torch.sigmoid(ins[0])
        if op == "Rsqrt":
            return torch.rsqrt(d(ins[0]))
        if op == "SquaredDifference":
            return (d(ins[0]) - d(ins[1])).square()
        if op in ("MaxPool", "AvgPool"):
            ks, st = list(node.attr["ksize"].list.i), list(node.attr["strides"].list.i)
            if ks[0] != 1 or ks[3] != 1 or st[0] != 1 or st[3] != 1:
                raise NotImplementedError(f"{op} over the batch or channel axis ({node.name})")
            x = ins[0].permute(0, 3, 1, 2)
            pads = _window_pads(x, ks[1:3], st[1:3], node.attr["padding"].s.decode())
            if op == "MaxPool":
                y = F.max_pool2d(F.pad(x, pads, value=float("-inf")), ks[1:3], st[1:3])
            else:  # the sum over the window's valid cells, over their count
                s = F.avg_pool2d(F.pad(x, pads), ks[1:3], st[1:3], divisor_override=1)
                c = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pads), ks[1:3], st[1:3],
                                 divisor_override=1)
                y = s / c
            return y.permute(0, 2, 3, 1)
        if op == "ConcatV2":
            return torch.cat([d(v) for v in ins[:-1]], dim=int(np.asarray(ins[-1])))
        if op == "Mean":
            axes = tuple(int(a) for a in np.ravel(np.asarray(ins[1])))
            return d(ins[0]).mean(dim=axes, keepdim=node.attr["keep_dims"].b)
        if op == "MirrorPad":
            return _reflect_pad(ins[0], np.asarray(ins[1]))
        if op == "ResizeNearestNeighbor":
            if node.attr["align_corners"].b or node.attr["half_pixel_centers"].b:
                raise NotImplementedError(f"ResizeNearestNeighbor's modern modes ({node.name})")
            oh, ow = (int(v) for v in np.ravel(np.asarray(ins[1])))
            x = ins[0]
            h_in, w_in = x.shape[1], x.shape[2]
            # TF's legacy nearest: src = floor(dst · in / out), clamped
            ih = np.minimum((np.arange(oh) * h_in / oh).astype(np.int32), h_in - 1)
            iw = np.minimum((np.arange(ow) * w_in / ow).astype(np.int32), w_in - 1)
            return x.index_select(1, torch.from_numpy(ih).long().to(x.device)).index_select(
                2, torch.from_numpy(iw).long().to(x.device))
        if op == "ExpandDims":
            return d(ins[0]).unsqueeze(int(np.asarray(ins[1])))
        if op == "Squeeze":
            dims = tuple(node.attr["squeeze_dims"].list.i)
            x = d(ins[0])
            return x.squeeze(dims) if dims else x.squeeze()
        if op == "Shape":
            return np.asarray(tuple(ins[0].shape), np.int32)
        if op == "StridedSlice":  # shape arithmetic only (1-D int arrays)
            arr = np.asarray(ins[0])
            b, e, s = (int(np.ravel(np.asarray(v))[0]) for v in ins[1:4])
            return arr[b] if node.attr["shrink_axis_mask"].i else arr[b:e:s]
        if op == "Pack":
            return np.stack([np.asarray(v) for v in ins])
        raise NotImplementedError(f"TF op {op} ({node.name})")

    def forward(self, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """(content NHWC [0,1], style NHWC [0,1]) → stylized NHWC [0,1]."""
        i_c, i_s = self.placeholder_args[0], self.placeholder_args[1]
        outs = self._run({i_c: content, i_s: style})
        return next(iter(outs.values()))
