"""Caffe SSD graph executor: the res10 300×300 face detector.

Counterpart of ``neuralstyletransferv1_tpu/models/caffe_ssd.py``. The
prototxt and caffemodel are read first-party (``io/caffe.py``); the conv
trunk (ResNet-10 and the SSD heads) runs in torch, NCHW, on the device; the
prior boxes (they depend only on shapes) and DetectionOutput's decode and
NMS (small and data-dependent) run in numpy on the host.

Layer semantics follow Caffe, as the JAX executor has them: symmetric conv
pads with floor output sizing, ceil-mode max pooling (windows clipped at the
right and bottom border), BatchNorm's running sums divided by its
``scale_factor`` blob at load, the SSD fork's ``Normalize`` (per-pixel L2
across channels, eps 1e-10 inside the root, times a learned per-channel
scale), ``Permute`` / ``Flatten`` / ``Concat`` in Caffe's order, PriorBox's
box order (min, √(min·max), then the aspect ratios with flips) and the
CENTER_SIZE decode with per-coordinate variances.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..io import caffe as cio


def _ints(msg, key, default=None):
    v = msg.many(key) if msg else []
    return [int(x) for x in v] if v else ([] if default is None else default)


def _int1(msg, key, default):
    v = msg.one(key) if msg else None
    return int(v) if v is not None else default


def _float1(msg, key, default):
    v = msg.one(key) if msg else None
    return float(v) if v is not None else default


def _bool1(msg, key, default):
    v = msg.one(key) if msg else None
    if v is None:
        return default
    return str(v).lower() in ("true", "1")


# ---------------------------------------------------------------------------
# layer ops (NCHW, f32)
# ---------------------------------------------------------------------------


def _max_pool_ceil(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Caffe's ceil-mode max pool: ceil((H − k) / s) + 1 windows, the last
    ones clipped at the border (-inf past it)."""
    H, W = x.shape[2], x.shape[3]
    out_h = -(-(H - k) // s) + 1
    out_w = -(-(W - k) // s) + 1
    pad_h = max(0, (out_h - 1) * s + k - H)
    pad_w = max(0, (out_w - 1) * s + k - W)
    return F.max_pool2d(F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf")), k, s)


def _batch_norm(x, mean, var, eps=1e-5):
    """mean/var already divided by the caffemodel's scale_factor blob."""
    return (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var.view(1, -1, 1, 1) + eps)


def _normalize(x, scale):
    """The SSD fork's NormalizeLayer: per-pixel L2 across C × per-channel scale."""
    norm = torch.sqrt(x.square().sum(dim=1, keepdim=True) + 1e-10)
    return x / norm * scale.view(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# PriorBox (host; shapes only)
# ---------------------------------------------------------------------------


def prior_boxes(feat_hw, img_hw, pp) -> np.ndarray:
    """[2, num_priors·4]: row 0 the boxes (xmin, ymin, xmax, ymax, normalized),
    row 1 the variances, in Caffe PriorBoxLayer's order."""
    fh, fw = feat_hw
    ih, iw = img_hw
    min_sizes = [float(v) for v in pp.many("min_size")]
    max_sizes = [float(v) for v in pp.many("max_size")]
    ars_in = [float(v) for v in pp.many("aspect_ratio")]
    flip = _bool1(pp, "flip", True)
    clip = _bool1(pp, "clip", False)
    variance = [float(v) for v in pp.many("variance")] or [0.1]
    step = _float1(pp, "step", 0.0)
    offset = _float1(pp, "offset", 0.5)
    step_h = step or ih / fh
    step_w = step or iw / fw

    ars = [1.0]
    for ar in ars_in:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)

    boxes = []
    for i in range(fh):
        for j in range(fw):
            cx = (j + offset) * step_w
            cy = (i + offset) * step_h
            for k, s in enumerate(min_sizes):
                bw = bh = s
                boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
                if max_sizes:
                    bw = bh = np.sqrt(s * max_sizes[k])
                    boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
                for ar in ars:
                    if abs(ar - 1.0) < 1e-6:
                        continue
                    bw = s * np.sqrt(ar)
                    bh = s / np.sqrt(ar)
                    boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
    b = np.asarray(boxes, np.float32)
    b[:, 0::2] /= iw
    b[:, 1::2] /= ih
    if clip:
        b = np.clip(b, 0.0, 1.0)
    if len(variance) == 1:
        var = np.full_like(b, variance[0])
    else:
        var = np.tile(np.asarray(variance, np.float32), (b.shape[0], 1))
    return np.stack([b.ravel(), var.ravel()], 0)


# ---------------------------------------------------------------------------
# DetectionOutput (host)
# ---------------------------------------------------------------------------


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float, top_k: int):
    order = np.argsort(-scores)[:top_k]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-12)
        order = rest[iou <= iou_thr]
    return keep


def decode_detections(loc, conf, priors, *, num_classes=2, background=0, conf_thr=0.01,
                      nms_thr=0.45, top_k=400, keep_top_k=200, clip=True) -> np.ndarray:
    """loc [P·4], conf [P·C], priors [2, P·4] → [N, 7] rows (img_id, label,
    score, xmin, ymin, xmax, ymax): the CENTER_SIZE decode, then per class
    the confidence threshold and NMS, the rows by score."""
    pb = priors[0].reshape(-1, 4)
    var = priors[1].reshape(-1, 4)
    loc = loc.reshape(-1, 4)
    conf = conf.reshape(-1, num_classes)
    pw = pb[:, 2] - pb[:, 0]
    ph = pb[:, 3] - pb[:, 1]
    pcx = (pb[:, 0] + pb[:, 2]) / 2
    pcy = (pb[:, 1] + pb[:, 3]) / 2
    cx = var[:, 0] * loc[:, 0] * pw + pcx
    cy = var[:, 1] * loc[:, 1] * ph + pcy
    # the exponent clamp only guards float32 overflow on degenerate weights
    w = np.exp(np.minimum(var[:, 2] * loc[:, 2], 87.0)) * pw
    h = np.exp(np.minimum(var[:, 3] * loc[:, 3], 87.0)) * ph
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    rows = []
    for c in range(num_classes):
        if c == background:
            continue
        sc = conf[:, c]
        m = sc > conf_thr
        if not m.any():
            continue
        idx = np.flatnonzero(m)
        for k in _nms(boxes[idx], sc[idx], nms_thr, top_k):
            i = idx[k]
            rows.append([0.0, float(c), float(sc[i]), *boxes[i]])
    rows.sort(key=lambda r: -r[2])
    return np.asarray(rows[:keep_top_k], np.float32).reshape(-1, 7)


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


@dataclass
class CaffeSSD:
    """An executable Caffe graph: the trunk on ``device``, the detection
    head on the host."""

    layers: list
    input_name: str
    input_shape: tuple
    params: dict  # layer name → its blobs as tensors on the device
    priorbox_layers: list
    detection_param: object | None
    det_bottoms: list | None
    device: torch.device

    @torch.no_grad()
    def trunk(self, x) -> dict:
        """NCHW input (numpy or tensor) → the head tensors: ``__loc__`` and
        ``__conf__`` (the DetectionOutput's inputs) or the last top, and a
        ``__shape__<PriorBox>`` slice of each PriorBox's feature map."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        tensors = {self.input_name: x}
        heads = {}
        last_top = self.input_name
        for l in self.layers:
            ltype, name = l.one("type"), l.one("name")
            bots, tops = l.many("bottom"), l.many("top")
            if ltype in ("PriorBox", "DetectionOutput"):
                if ltype == "PriorBox":  # a 1-channel slice: forward() reads H, W
                    heads[f"__shape__{name}"] = tensors[bots[0]][:, :1] * 0
                continue
            if bots and any(bn not in tensors for bn in bots):
                continue  # the prior-box-only subgraph (mbox_priorbox's concat)
            b0 = tensors[bots[0]] if bots else None
            w = self.params.get(name, [])
            if ltype == "Convolution":
                cp = l.one("convolution_param")
                bias = w[1] if _bool1(cp, "bias_term", True) and len(w) > 1 else None
                y = F.conv2d(b0, w[0], bias, stride=_int1(cp, "stride", 1),
                             padding=_int1(cp, "pad", 0), dilation=_int1(cp, "dilation", 1))
            elif ltype == "BatchNorm":
                y = _batch_norm(b0, w[0], w[1])
            elif ltype == "Scale":
                y = b0 * w[0].view(1, -1, 1, 1)
                if _bool1(l.one("scale_param"), "bias_term", False) and len(w) > 1:
                    y = y + w[1].view(1, -1, 1, 1)
            elif ltype == "ReLU":
                y = F.relu(b0)
            elif ltype == "Pooling":
                pp = l.one("pooling_param")
                y = _max_pool_ceil(b0, _int1(pp, "kernel_size", 2), _int1(pp, "stride", 1))
            elif ltype == "Eltwise":
                y = b0
                for bn in bots[1:]:
                    y = y + tensors[bn]
            elif ltype == "Normalize":
                y = _normalize(b0, w[0])
            elif ltype == "Permute":
                y = b0.permute(*_ints(l.one("permute_param"), "order", [0, 1, 2, 3]))
            elif ltype == "Flatten":
                y = b0.reshape(b0.shape[0], -1)
            elif ltype == "Concat":
                y = torch.cat([tensors[bn] for bn in bots],
                              dim=_int1(l.one("concat_param"), "axis", 1))
            elif ltype == "Reshape":
                dims = _ints(l.one("reshape_param").one("shape"), "dim")
                y = b0.reshape([b0.shape[i] if d == 0 else d for i, d in enumerate(dims)])
            elif ltype == "Softmax":
                y = F.softmax(b0, dim=_int1(l.one("softmax_param"), "axis", 1))
            else:
                raise NotImplementedError(f"Caffe layer type {ltype}")
            tensors[tops[0]] = y
            last_top = tops[0]
        if self.det_bottoms:
            heads["__loc__"] = tensors[self.det_bottoms[0]]
            heads["__conf__"] = tensors[self.det_bottoms[1]]
        else:
            heads[last_top] = tensors[last_top]
        return heads

    def forward(self, blob: np.ndarray) -> np.ndarray:
        """cv2.dnn's contract: an NCHW float blob → [1, 1, N, 7] detections
        (without a DetectionOutput layer: the last top, as numpy)."""
        heads = {k: v.cpu().numpy() for k, v in self.trunk(blob).items()}
        if self.detection_param is None:
            return heads[next(reversed(heads))]
        dp = self.detection_param
        img_hw = (blob.shape[2], blob.shape[3])
        priors = np.concatenate([
            prior_boxes(heads[f"__shape__{name}"].shape[2:4], img_hw, pp)
            for name, pp, _feat in self.priorbox_layers], axis=1)
        nms = dp.one("nms_param")
        dets = decode_detections(
            heads["__loc__"].ravel(), heads["__conf__"].ravel(), priors,
            num_classes=_int1(dp, "num_classes", 2),
            background=_int1(dp, "background_label_id", 0),
            conf_thr=_float1(dp, "confidence_threshold", 0.01),
            nms_thr=_float1(nms, "nms_threshold", 0.45) if nms else 0.45,
            top_k=_int1(nms, "top_k", 400) if nms else 400,
            keep_top_k=_int1(dp, "keep_top_k", 200),
            clip=_bool1(dp, "clip", True),
        )
        return dets.reshape(1, 1, -1, 7)


def load_caffe_ssd(prototxt: str | Path, caffemodel: str | Path,
                   device: torch.device | str = "cuda") -> CaffeSSD:
    """Parse the graph and its weights; the trunk's blobs on ``device``
    (``cuda`` needs a visible GPU, ``cpu`` is an explicit CPU run)."""
    dev = resolve_device(device) if isinstance(device, str) else device
    net = cio.load_prototxt(prototxt)
    blobs = cio.load_caffemodel(caffemodel)
    input_name = net.one("input", "data")
    ishape = net.one("input_shape")
    input_shape = (tuple(int(d) for d in ishape.many("dim")) if ishape is not None
                   else tuple(_ints(net, "input_dim", [1, 3, 300, 300])))
    layers = list(net.many("layer"))
    priorbox_layers, detection_param, det_bottoms = [], None, None
    for l in layers:
        if l.one("type") == "PriorBox":
            priorbox_layers.append((l.one("name"), l.one("prior_box_param"), l.many("bottom")[0]))
        if l.one("type") == "DetectionOutput":
            detection_param = l.one("detection_output_param")
            det_bottoms = l.many("bottom")
    # BatchNorm stores running sums: the statistics are the blobs over the
    # scale_factor blob, divided here once
    bn_names = {l.one("name") for l in layers if l.one("type") == "BatchNorm"}
    params = {}
    for k, v in blobs.items():
        if k in bn_names and len(v) >= 3:
            sf = float(np.ravel(v[2])[0]) if v[2].size else 1.0
            inv = 1.0 / sf if sf != 0 else 0.0
            v = [v[0] * inv, v[1] * inv]
        params[k] = [torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev) for b in v]
    return CaffeSSD(layers=layers, input_name=input_name,
                    input_shape=input_shape, params=params, priorbox_layers=priorbox_layers,
                    detection_param=detection_param, det_bottoms=det_bottoms, device=dev)


# ---------------------------------------------------------------------------
# the face detection API
# ---------------------------------------------------------------------------


def blob_from_image_bgr(img_bgr: np.ndarray, size=(300, 300),
                        mean=(104.0, 177.0, 123.0)) -> np.ndarray:
    """cv2.dnn.blobFromImage(img, 1.0, size, mean, swapRB=False, crop=False)."""
    import cv2

    resized = cv2.resize(img_bgr, size, interpolation=cv2.INTER_LINEAR)
    x = resized.astype(np.float32) - np.asarray(mean, np.float32)
    return x.transpose(2, 0, 1)[None]


def detect_faces(image_path, prototxt, caffemodel, confidence_threshold=0.5,
                 device: torch.device | str = "cuda"):
    """Face dicts (id, bbox, center, area, coverage, confidence,
    aspect_ratio), sorted by area, largest first; [] when the image or the
    model files are missing."""
    import cv2

    img = cv2.imread(str(image_path))
    if img is None:
        print(f"[faces] Failed to load image: {image_path}")
        return []
    h, w = img.shape[:2]
    if not Path(prototxt).exists() or not Path(caffemodel).exists():
        print(f"[faces] Error: DNN face detector model not found ({prototxt} / {caffemodel})")
        return []
    detections = load_caffe_ssd(prototxt, caffemodel, device).forward(blob_from_image_bgr(img))
    results = []
    for i in range(detections.shape[2]):
        confidence = detections[0, 0, i, 2]
        if confidence < confidence_threshold:
            continue
        x1 = max(0, int(detections[0, 0, i, 3] * w))
        y1 = max(0, int(detections[0, 0, i, 4] * h))
        x2 = min(w, int(detections[0, 0, i, 5] * w))
        y2 = min(h, int(detections[0, 0, i, 6] * h))
        fw, fh = x2 - x1, y2 - y1
        if fw <= 0 or fh <= 0:
            continue
        results.append({
            "id": i + 1,
            "bbox": (x1, y1, fw, fh),
            "center": (x1 + fw / 2, y1 + fh / 2),
            "area": fw * fh,
            "coverage": fw * fh / (w * h) * 100,
            "confidence": float(confidence),
            "aspect_ratio": fw / fh if fh > 0 else 1.0,
        })
    results.sort(key=lambda f: f["area"], reverse=True)
    for i, face in enumerate(results):
        face["id"] = i + 1
    return results
