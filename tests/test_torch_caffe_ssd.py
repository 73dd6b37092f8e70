"""The Caffe SSD face detector (``io/caffe.py``, ``models/caffe_ssd.py``): the
port against the JAX package on the CPU.

The res10 prototxt and caffemodel are not in the repo. The graph here is
``chip_smoke.SSD_PROTOTXT`` (a res10-style SSD at narrow widths: BatchNorm
with a scale factor, Scale, ceil-mode pooling, a residual Eltwise, the L2
``Normalize``, Permute / Flatten / Concat heads on two maps, PriorBox, the
Reshape / Softmax conf chain and DetectionOutput) with the seeded weights
``chip_smoke.write_ssd`` writes. The hand-value tests are copies of the JAX
package's (``tests/test_caffe_ssd.py``: prior boxes, the CENTER_SIZE
decode, NMS). Tolerances: the heads 1e-5 relative MAE, the detections 1e-5
absolute, prior boxes exact to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from neuralstyletransferv1_tpu.io import caffe as jcio
from neuralstyletransferv1_tpu.models import caffe_ssd as jssd
from neuralstyletransferv1_torch.io import caffe as tcio
from neuralstyletransferv1_torch.models import caffe_ssd as tssd

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    """(prototxt, caffemodel, blobs) of the seeded small SSD."""
    return chip_smoke.write_ssd(tmp_path_factory.mktemp("ssd"), 3)


@pytest.fixture(scope="module")
def nets(ssd):
    """(the port's graph on the CPU, JAX's graph)."""
    return tssd.load_caffe_ssd(ssd[0], ssd[1], CPU), jssd.load_caffe_ssd(ssd[0], ssd[1])


def _blob(seed):
    return np.random.default_rng(seed).normal(0, 50, (1, 3, 300, 300)).astype(np.float32)


def test_prototxt_and_caffemodel_io_match_jax(ssd, tmp_path):
    """The parser, the reader and the writer: the same messages, blobs and
    bytes as the JAX package's."""
    proto, model, blobs = ssd
    text = proto.read_text()
    assert tcio.parse_prototxt(text) == jcio.parse_prototxt(text)
    ours, ref = tcio.load_caffemodel(model), jcio.load_caffemodel(model)
    assert set(ours) == set(ref) == set(blobs)
    for name in blobs:
        for a, b, c in zip(ours[name], ref[name], blobs[name]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    types = {l.one("name"): l.one("type") for l in tcio.parse_prototxt(text).many("layer")}
    jcio.write_caffemodel(tmp_path / "j.caffemodel", blobs, types)
    assert model.read_bytes() == (tmp_path / "j.caffemodel").read_bytes()
    # legacy num/channels/height/width blob dims
    legacy = (tcio._field(1, 0) + tcio._varint(2) + tcio._field(2, 0) + tcio._varint(3)
              + tcio._len_delim(5, np.arange(6, dtype="<f4").tobytes()))
    assert tcio._parse_blob(legacy).shape == jcio._parse_blob(legacy).shape == (2, 3, 1, 1)


def test_trunk_matches_jax(nets):
    """The heads (loc, the flattened softmax conf) and every PriorBox map's
    size on a seeded blob."""
    ours, ref = nets
    x = _blob(0)
    got = {k: v.numpy() for k, v in ours.trunk(x).items()}
    want = {k: np.asarray(v) for k, v in ref.trunk(jnp.asarray(x)).items()}
    assert set(got) == set(want) == {"__loc__", "__conf__", "__shape__f1_mbox_priorbox",
                                     "__shape__f2_mbox_priorbox"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        if not k.startswith("__shape__"):
            assert np.abs(got[k] - want[k]).mean() <= 1e-5 * np.abs(want[k]).mean(), k
    assert got["__shape__f1_mbox_priorbox"].shape[2:] == (75, 75)  # the ceil-mode pool
    assert got["__conf__"].std() > 1e-2


def test_detections_match_jax(nets):
    ours, ref = nets
    x = _blob(1)
    a, b = ours.forward(x), ref.forward(x)
    assert a.shape == b.shape and a.shape[2] > 0
    assert np.abs(a - b).max() <= 1e-5


def test_detect_faces_matches_jax(ssd, tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    img = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
    p = tmp_path / "img.png"
    cv2.imwrite(str(p), img)
    ours = tssd.detect_faces(p, ssd[0], ssd[1], 0.5, device="cpu")
    ref = jssd.detect_faces(p, ssd[0], ssd[1], 0.5)
    assert len(ours) == len(ref) > 0
    for f, g in zip(ours, ref):
        assert set(f) == set(g) == {"id", "bbox", "center", "area", "coverage", "confidence",
                                    "aspect_ratio"}
        assert f["bbox"] == g["bbox"] and f["id"] == g["id"]
        assert abs(f["confidence"] - g["confidence"]) <= 1e-5
    assert tssd.detect_faces(tmp_path / "absent.png", ssd[0], ssd[1], device="cpu") == []
    assert tssd.detect_faces(p, tmp_path / "no.prototxt", ssd[1], device="cpu") == []


def test_ceil_pool_and_normalize_match_jax():
    """Caffe's ceil-mode pool (the last windows clipped at the border) at
    sizes off the stride, and the L2 Normalize."""
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 13, 10)).astype(np.float32)
    for k, s in ((3, 2), (2, 2), (3, 3)):
        np.testing.assert_array_equal(tssd._max_pool_ceil(torch.from_numpy(x), k, s).numpy(),
                                      np.asarray(jssd._max_pool_ceil(jnp.asarray(x), k, s)))
    sc = np.linspace(0.5, 2, 5).astype(np.float32)
    np.testing.assert_allclose(tssd._normalize(torch.from_numpy(x), torch.from_numpy(sc)).numpy(),
                               np.asarray(jssd._normalize(jnp.asarray(x), jnp.asarray(sc))),
                               rtol=1e-6, atol=1e-6)


def test_load_needs_cuda_without_device(ssd, monkeypatch):
    """The detector runs on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tssd.load_caffe_ssd(ssd[0], ssd[1])


# ---------------------------------------------------------------------------
# copies of the JAX package's hand-value tests (tests/test_caffe_ssd.py)
# ---------------------------------------------------------------------------


def test_priorbox_hand_values():
    """1×1 feature, 300×300 image, min 30 / max 60 / ar 2 flip — vs hand
    math from the Caffe SSD PriorBoxLayer definition."""
    pp = tcio.parse_prototxt(
        "min_size: 30.0 max_size: 60.0 aspect_ratio: 2 flip: true clip: false "
        "variance: 0.1 variance: 0.1 variance: 0.2 variance: 0.2 "
        "step: 300 offset: 0.5"
    )
    out = tssd.prior_boxes((1, 1), (300, 300), pp)
    boxes = out[0].reshape(-1, 4) * 300.0
    s, m = 30.0, np.sqrt(30.0 * 60.0)
    w2, h2 = 30 * np.sqrt(2), 30 / np.sqrt(2)
    want = np.array([
        [150 - s / 2, 150 - s / 2, 150 + s / 2, 150 + s / 2],
        [150 - m / 2, 150 - m / 2, 150 + m / 2, 150 + m / 2],
        [150 - w2 / 2, 150 - h2 / 2, 150 + w2 / 2, 150 + h2 / 2],
        [150 - h2 / 2, 150 - w2 / 2, 150 + h2 / 2, 150 + w2 / 2],
    ], np.float32)
    np.testing.assert_allclose(boxes, want, atol=1e-3)
    var = out[1].reshape(-1, 4)
    np.testing.assert_allclose(var, np.tile([0.1, 0.1, 0.2, 0.2], (4, 1)), atol=1e-7)


@pytest.mark.parametrize("spec", [
    "min_size: 30.0 max_size: 60.0 aspect_ratio: 2 flip: true clip: false variance: 0.1 "
    "variance: 0.1 variance: 0.2 variance: 0.2",
    "min_size: 16.0 aspect_ratio: 3 aspect_ratio: 3 flip: false clip: true variance: 0.2",
    "min_size: 60.0 max_size: 111.0 aspect_ratio: 2 aspect_ratio: 0.5 step: 8 offset: 0.3"])
def test_prior_boxes_match_jax(spec):
    ours = tssd.prior_boxes((5, 7), (300, 420), tcio.parse_prototxt(spec))
    ref = jssd.prior_boxes((5, 7), (300, 420), jcio.parse_prototxt(spec))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_decode_hand_values():
    """CENTER_SIZE decode of one prior against hand math."""
    prior = np.array([0.4, 0.4, 0.6, 0.6], np.float32)  # pw=ph=0.2, c=(0.5,0.5)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    loc = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
    conf = np.array([0.3, 0.7], np.float32)
    priors = np.stack([prior, var], 0)
    det = tssd.decode_detections(loc, conf, priors)
    assert det.shape == (1, 7)
    cx = 0.1 * 1.0 * 0.2 + 0.5
    cy = 0.1 * -1.0 * 0.2 + 0.5
    w = np.exp(0.2 * 0.5) * 0.2
    h = 0.2
    np.testing.assert_allclose(det[0, 2], 0.7, atol=1e-6)
    np.testing.assert_allclose(
        det[0, 3:], [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], atol=1e-6
    )


def test_nms_suppresses_overlaps():
    boxes = np.array([
        [0.1, 0.1, 0.5, 0.5],
        [0.12, 0.12, 0.52, 0.52],  # heavy overlap with 0
        [0.6, 0.6, 0.9, 0.9],
    ], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    keep = tssd._nms(boxes, scores, 0.45, 400)
    assert keep == [0, 2]
    assert keep == jssd._nms(boxes, scores, 0.45, 400)
