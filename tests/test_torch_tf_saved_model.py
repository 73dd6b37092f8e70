"""The port's SavedModel executor (``io/tf_saved_model.py``) against the TF
runtime and the JAX package's executor, on the CPU.

The reference's magenta SavedModel is not in the repo, so the test writes
its own with the installed ``tensorflow``: a small conditional network whose
function graph holds every op of the executors' table (``Conv2D`` with SAME
padding at stride 2 on odd sizes, ``FusedBatchNormV3``, both pools at SAME
stride 2, ``MirrorPad``, the legacy ``ResizeNearestNeighbor`` up and down,
the host shape arithmetic ``Shape`` / ``StridedSlice`` / ``Pack`` / ``Mul``,
…). ``tf.saved_model.load``'s serving signature is the oracle. JAX's
``_resolve_call_chain`` follows the graph that this ``tensorflow`` writes,
so both executors are held to it and to each other. Tolerances: f32, 1e-5
absolute on outputs in [0, 1].

``tensorflow`` is imported inside the fixtures (each test worker imports
every test file, and the import takes ~20 s).
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from neuralstyletransferv1_tpu.engine import pipeline as jpipe
from neuralstyletransferv1_tpu.io import tf_saved_model as jtsm
from neuralstyletransferv1_torch.engine import pipeline as tpipe
from neuralstyletransferv1_torch.io import tf_saved_model as ttsm

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
# every op of the executors' table (NoOp: the function's control output)
TABLE = {"Const", "Identity", "CheckNumerics", "StopGradient", "ReadVariableOp", "NoOp",
         "Conv2D", "FusedBatchNormV3", "BiasAdd", "Relu", "Relu6", "Sigmoid", "MaxPool",
         "AvgPool", "ConcatV2", "Mean", "MirrorPad", "ResizeNearestNeighbor", "AddV2", "Sub",
         "Mul", "Rsqrt", "SquaredDifference", "ExpandDims", "Squeeze", "Shape",
         "StridedSlice", "Pack"}


def _module(tf, mirror_mode="REFLECT"):
    """A conditional net: a style embedding (conv, Relu6, mean) shifts a
    content branch (mirror pad, SAME stride-2 conv, BN, instance norm,
    both pools, concat), resized ×2 by its own shape and back to the
    content's size, a SAME conv to 3 channels, sigmoid."""
    rng = np.random.default_rng(0)

    def var(shape, name, scale=0.3, lo=None):
        a = (rng.uniform(lo, 1.5, shape) if lo is not None
             else rng.normal(0, scale, shape)).astype(np.float32)
        return tf.Variable(a, name=name)

    class Net(tf.Module):
        def __init__(self):
            super().__init__()
            self.ws = var((3, 3, 3, 8), "style/conv/weights")
            self.w1 = var((3, 3, 3, 8), "contract/conv1/weights")
            self.b1 = var((8,), "contract/conv1/biases", 0.1)
            self.gamma = var((8,), "contract/bn/gamma", lo=0.5)
            self.beta = var((8,), "contract/bn/beta", 0.1)
            self.mean = var((8,), "contract/bn/moving_mean", 0.1)
            self.var = var((8,), "contract/bn/moving_variance", lo=0.5)
            self.g2 = var((8,), "cin/gamma", lo=0.5)
            self.w2 = var((3, 3, 16, 3), "expand/conv/weights")

        @tf.function(input_signature=[tf.TensorSpec([None, None, None, 3], tf.float32),
                                      tf.TensorSpec([None, None, None, 3], tf.float32)])
        def __call__(self, content, style):
            s = tf.nn.relu6(tf.nn.conv2d(style, self.ws, 1, "VALID"))
            s = tf.expand_dims(tf.expand_dims(tf.reduce_mean(s, axis=[1, 2]), 1), 1)
            x = tf.pad(content, [[0, 0], [2, 2], [2, 2], [0, 0]], mode=mirror_mode)
            x = tf.nn.bias_add(tf.nn.conv2d(x, self.w1, 2, "SAME"), self.b1)
            x, _, _ = tf.compat.v1.nn.fused_batch_norm(x, self.gamma, self.beta, self.mean,
                                                       self.var, is_training=False)
            x = tf.nn.relu(x)
            m = tf.reduce_mean(x, axis=[1, 2], keepdims=True)
            v = tf.reduce_mean(tf.math.squared_difference(x, m), axis=[1, 2], keepdims=True)
            x = (x - m) * tf.math.rsqrt(v + 1e-5) * self.g2 + s
            x = tf.debugging.check_numerics(tf.stop_gradient(tf.identity(x)), "x")
            y = tf.concat([tf.nn.max_pool2d(x, 2, 2, "SAME"), tf.nn.avg_pool2d(x, 3, 2, "SAME")],
                          axis=3)
            y = tf.compat.v1.image.resize_nearest_neighbor(y, tf.shape(y)[1:3] * 2)
            shp = tf.shape(content)
            y = tf.compat.v1.image.resize_nearest_neighbor(y, tf.stack([shp[1], shp[2]]))
            y = tf.nn.conv2d(y, self.w2, 1, "SAME")
            t = tf.reduce_mean(tf.squeeze(m, axis=[1, 2]), axis=1, keepdims=True)
            return tf.sigmoid(y + tf.expand_dims(tf.expand_dims(t, 1), 1))

    return Net()


def _save(tf, path: Path, mirror_mode="REFLECT") -> Path:
    tf.saved_model.save(_module(tf, mirror_mode), str(path))
    return path


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def saved(tf, tmp_path_factory):
    """(SavedModel dir, its serving signature)."""
    d = _save(tf, tmp_path_factory.mktemp("magenta_root") / "sm")
    return d, tf.saved_model.load(str(d)).signatures["serving_default"]


def _inputs(seed, n=2, h=31, w=37, s=21):
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, w, 3)).astype(np.float32),
            rng.random((1, s, s, 3)).astype(np.float32))


def _tf_run(tf, sig, content, style):
    return sig(content=tf.constant(content), style=tf.constant(style))["output_0"].numpy()


def test_graph_holds_every_op_of_the_table(saved):
    fn, sources = ttsm._resolve_call_chain(ttsm.load_saved_model_proto(saved[0]))
    assert {n.op for n in fn.node_def} == TABLE
    assert sources[:2] == ["serving_default_content", "serving_default_style"]
    # the same function and argument sources as the JAX package resolves
    jfn, jsources = jtsm._resolve_call_chain(jtsm.load_saved_model_proto(saved[0]))
    assert jfn.signature.name == fn.signature.name and jsources == sources


def test_variables_match_jax(saved):
    ours, ref = ttsm.load_variables(saved[0]), jtsm.load_variables(saved[0])
    assert set(ours) == set(ref) and "contract/conv1/weights" in ours
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert ttsm.checkpoint_name_map(ttsm.load_saved_model_proto(saved[0])) == \
        jtsm.checkpoint_name_map(jtsm.load_saved_model_proto(saved[0]))


@pytest.mark.parametrize("shape", [(2, 31, 37, 21), (1, 32, 32, 16), (3, 17, 24, 9)],
                         ids=["odd", "even", "small"])
def test_executor_matches_tf_and_jax(tf, saved, shape):
    """Odd sizes put SAME's odd cell after at stride 2 in the conv and both
    pools; the even tile is the slot's shape."""
    n, h, w, s = shape
    content, style = _inputs(n, n, h, w, s)
    want = _tf_run(tf, saved[1], content, style)
    ours = ttsm.TFGraphExecutor(saved[0]).forward(torch.from_numpy(content),
                                                  torch.from_numpy(style)).numpy()
    ref = np.asarray(jtsm.TFGraphExecutor(saved[0]).forward(jnp.asarray(content),
                                                            jnp.asarray(style)))
    assert ours.shape == want.shape == ref.shape == (n, h, w, 3)
    assert np.abs(ours - want).max() <= TOL, np.abs(ours - want).max()
    assert np.abs(ours - ref).max() <= TOL, np.abs(ours - ref).max()
    assert want.std() > 1e-2


def test_mirror_pad_reflects_whatever_its_mode(tf, tmp_path):
    """The JAX executor pads ``MirrorPad`` as reflect under SYMMETRIC too;
    the port copies it: equal to JAX, not to the TF runtime."""
    d = _save(tf, tmp_path / "sym", mirror_mode="SYMMETRIC")
    content, style = _inputs(5)
    ours = ttsm.TFGraphExecutor(d).forward(torch.from_numpy(content),
                                           torch.from_numpy(style)).numpy()
    ref = np.asarray(jtsm.TFGraphExecutor(d).forward(jnp.asarray(content), jnp.asarray(style)))
    want = _tf_run(tf, tf.saved_model.load(str(d)).signatures["serving_default"], content, style)
    assert np.abs(ours - ref).max() <= TOL
    assert np.abs(ours - want).max() > 1e-3


def test_same_pads_put_the_odd_cell_after():
    assert ttsm._same_pads(34, 3, 2) == (0, 1)
    assert ttsm._same_pads(17, 2, 2) == (0, 1)
    assert ttsm._same_pads(17, 3, 2) == (1, 1)
    assert ttsm._same_pads(16, 3, 1) == (1, 1)
    assert ttsm._same_pads(5, 1, 2) == (0, 0)


def test_magenta_slot_takes_the_savedmodel_from_the_model_root(tf, saved, tmp_path):
    """``--magenta_model_root`` holding the SavedModel: both engines' main()
    on one image take the real-weights path (tile 32, overlap 8); the
    outputs within 1 level on >= 99% of the values. Without tensorflow (the
    card's machine) ``find_savedmodel`` finds nothing and the slot falls back
    to the colour transfer, as in the JAX package."""
    from neuralstyletransferv1_torch.models import magenta as tm
    from neuralstyletransferv1_torch.models.magenta_stub import load_magenta_slot

    rng = np.random.default_rng(7)
    img, sty = tmp_path / "in.png", tmp_path / "style.png"
    Image.fromarray((rng.random((40, 72, 3)) * 255).astype(np.uint8)).save(img)
    Image.fromarray((rng.random((50, 50, 3)) * 255).astype(np.uint8)).save(sty)
    root = saved[0].parent
    assert tm.find_savedmodel(root) == str(saved[0])
    argv = ["--input_image", str(img), "--model_type", "magenta", "--magenta_style", str(sty),
            "--magenta_model_root", str(root), "--magenta_tile", "32", "--magenta_overlap", "8"]
    a, b = tmp_path / "torch.png", tmp_path / "jax.png"
    assert tpipe.main(argv + ["--output_image", str(a), "--device", "cpu",
                              "--work_dir", str(tmp_path / "_wt")]) == 0
    assert jpipe.main(argv + ["--output_image", str(b), "--work_dir", str(tmp_path / "_wj")]) == 0
    ua = np.asarray(Image.open(a), np.int32)
    ub = np.asarray(Image.open(b), np.int32)
    d = np.abs(ua - ub)
    assert ua.shape == (40, 72, 3) and (d <= 1).mean() >= 0.99 and ua.std() > 1.0

    args = SimpleNamespace(magenta_model_root=str(root), magenta_tile=32, magenta_overlap=8,
                           magenta_target_res=None)
    m = load_magenta_slot(str(sty), args)
    assert m.net.transfer_fn.__qualname__.startswith("savedmodel_transfer_fn")


def test_find_savedmodel_skips_what_it_cannot_read(tmp_path, monkeypatch):
    """A ``saved_model.pb`` whose reader raises (here: no tensorflow) is
    skipped, as in the JAX package, and the slot takes the colour transfer."""
    import builtins

    from neuralstyletransferv1_torch.models import magenta as tm

    d = tmp_path / "root" / "hash"
    d.mkdir(parents=True)
    (d / "saved_model.pb").write_bytes(b"")
    real_import = builtins.__import__

    def no_tf(name, *a, **k):
        if name.startswith("tensorflow"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tf)
    assert tm.find_savedmodel(tmp_path / "root") is None
    assert tm.find_savedmodel(tmp_path / "absent") is None


def test_tensorflow_is_imported_lazily():
    """No module of the port imports tensorflow when it is imported: only
    function bodies do (``io/tf_saved_model.py``, ``models/magenta.py``)."""
    inside = set()
    for f in sorted((ROOT / "neuralstyletransferv1_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in tree.body:
            for sub in ast.walk(node):
                mods = ([a.name for a in sub.names] if isinstance(sub, ast.Import) else
                        [sub.module or ""] if isinstance(sub, ast.ImportFrom) else [])
                if any(m.split(".")[0] == "tensorflow" for m in mods):
                    assert isinstance(node, (ast.FunctionDef, ast.ClassDef)), (f.name, node.lineno)
                    inside.add(f.name)
    assert inside == {"tf_saved_model.py", "magenta.py"}
