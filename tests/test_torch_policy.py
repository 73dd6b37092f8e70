"""Rules of the PyTorch port: no JAX at run time, no CPU fallback on the
CUDA path, and the kernels (K1, K2–K8b, K9a–K9e) against their plain
versions on the card (K10 and K11: ``test_torch_experiments.py``).

The JAX-import rule is checked statically (an AST scan), since the test
process itself imports jax. It covers the JAX package's ``experiments/``
scripts too: the port has its own counterparts of them.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.kernels import bf16_sites as k9
from neuralstyletransferv1_torch.kernels import dis_iter as k1
from neuralstyletransferv1_torch.kernels import int8_sites as k8

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "neuralstyletransferv1_torch"
ALLOWED_TPU_MODULES: set[str] = set()  # the port shares no module with the JAX package


def _imports(path: Path):
    """(module, names) for every import statement of a file, relative
    imports resolved against the port package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = path.resolve().relative_to(ROOT).parts[:-1] if path.is_relative_to(ROOT) else ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, []
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                mod = ".".join(list(pkg[:len(pkg) - node.level + 1]) + ([mod] if mod else []))
            yield mod, [a.name for a in node.names]


def _scan(files):
    bad = []
    for f in files:
        for mod, names in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "experiments"):
                bad.append((f.name, mod))
            if top == "neuralstyletransferv1_tpu":
                sub = mod.partition(".")[2]
                subs = {f"{sub}.{n}" if sub else n for n in names} if names else {sub}
                if not all(s in ALLOWED_TPU_MODULES or sub in ALLOWED_TPU_MODULES for s in subs):
                    bad.append((f.name, mod, names))
    return bad


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    assert _scan(files) == []


def test_chip_smoke_imports_nothing_of_jax():
    f = ROOT / "chip_smoke.py"
    mods = {m.split(".")[0] for m, _ in _imports(f)}
    assert not mods & {"jax", "jaxlib", "neuralstyletransferv1_tpu", "experiments"}


def test_scan_catches_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\n"
                   "from neuralstyletransferv1_tpu.ops import warp\n"
                   "from neuralstyletransferv1_tpu.io import checkpoints\n"
                   "from experiments import mk1_fusedconv\n"
                   "import experiments._bench\n")
    assert [b[1] for b in _scan([bad])] == ["jax.numpy", "neuralstyletransferv1_tpu.ops",
                                            "neuralstyletransferv1_tpu.io", "experiments",
                                            "experiments._bench"]


def test_main_without_device_needs_cuda(monkeypatch):
    """--device defaults to cuda; with no GPU visible main() raises instead
    of running on the CPU."""
    from neuralstyletransferv1_torch.engine import pipeline as tpipe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpipe.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tpipe.main(["--input_video", "a.mp4", "--output_video", "b.mp4", "--model", "m.pth"])
    for dev in ("tpu", "mps"):
        with pytest.raises(NotImplementedError):
            tpipe.main(["--device", dev])


def _k1_inputs(n, device, seed=0):
    rng = np.random.default_rng(seed)
    gen = {
        "nb": rng.random((n, 20, 20)) * 255, "t": rng.random((n, 8, 8)) * 255,
        "gx": rng.normal(0, 20, (n, 8, 8)), "gy": rng.normal(0, 20, (n, 8, 8)),
        "u0": rng.normal(0, 2, (n, 2)),
    }
    gx, gy = gen["gx"], gen["gy"]
    gen["hxx"] = (gx * gx).sum((1, 2))
    gen["hxy"] = (gx * gy).sum((1, 2))
    gen["hyy"] = (gy * gy).sum((1, 2))
    gen["det"] = gen["hxx"] * gen["hyy"] - gen["hxy"] ** 2
    gen["lo"] = gen["u0"] - 6
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in gen.items()}


def test_k1_cpu_tensors_take_the_plain_version():
    ins = _k1_inputs(37, "cpu")
    before = k1.LAUNCHES
    u, res = k1.dis_iter(**ins)
    assert k1.LAUNCHES == before
    pu, pres = k1.dis_iter_plain(**ins)
    assert torch.equal(u, pu) and torch.equal(res, pres)
    assert u.shape == (37, 2) and res.shape == (37,)
    o = u - ins["lo"]
    assert float(o.min()) >= 0.0 and float(o.max()) <= 12.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is a CUDA kernel with no CPU mode)")
    return torch.device("cuda")


# the four pyramid levels of a 1080p frame at ds2 (540×960), 2 pairs
@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", [(32, 59), (15, 29), (7, 14), (3, 6)])
def test_k1_kernel_matches_plain_on_card(cuda_device, ny, nx):
    n = 2 * ny * nx
    ins = _k1_inputs(n, cuda_device, seed=ny)
    before = k1.LAUNCHES
    u, res = k1.dis_iter(**ins)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    pu, pres = k1.dis_iter_plain(**ins)
    du = (u - pu).abs().max(dim=1).values
    same = du <= 1e-3
    assert float(same.float().mean()) >= 0.99
    assert float((res - pres).abs()[same].max()) <= 1e-3


@pytest.mark.cuda
def test_k1_wrapper_rejects_bad_inputs(cuda_device):
    ins = _k1_inputs(8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k1.dis_iter(**{**ins, "nb": ins["nb"].transpose(1, 2)})
    with pytest.raises(TypeError, match="float32"):
        k1.dis_iter(**{**ins, "t": ins["t"].double()})
    with pytest.raises(ValueError, match="expected cuda"):
        k1.dis_iter(**{**ins, "gx": ins["gx"].cpu()})


def _int8_inputs(device, c, co, h=19, w=37, seed=0):
    """Operands of an int8 site (B=2) at realistic scales."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, co)).astype(np.int8))
    return {
        "x": f32(rng.normal(0, 2, (2, h, w, c))).to(torch.bfloat16),
        "y": f32(rng.normal(0, 1, (2, h, w, c))).to(torch.bfloat16),
        "a": f32(rng.uniform(5, 40, (2, c))), "c": f32(rng.normal(0, 8, (2, c))),
        "a2": f32(rng.uniform(0.5, 1.5, (2, c))), "c2": f32(rng.normal(0, 0.3, (2, c))),
        "w": k8.pack_weights(wq).to(device),
        "ws": f32(rng.uniform(0.5, 2, co) / (127 * 127 * 12)), "bias": f32(rng.normal(0, 0.2, co)),
        "qa": f32(rng.uniform(10, 60, co)), "qc": f32(rng.normal(0, 10, co)),
        "codes": torch.from_numpy(rng.integers(0, 128, (2, h, w, c)).astype(np.int8)).to(device),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("c,co,halo", [(128, 128, "reflect"), (128, 256, "edge"),
                                       (64, 128, "edge")])
def test_k2_to_k5_match_plain_on_card(cuda_device, c, co, halo):
    """K2-K5 against their plain versions on the card: codes and bf16
    outputs bit-identical, the sums within 1e-5."""
    t = _int8_inputs(cuda_device, c, co)
    before = dict(k8.LAUNCHES)
    o, s = k8.res_site(t["x"], t["a"], t["c"], -127.0, t["w"], t["ws"], t["bias"], halo=halo)
    po, ps = k8.res_site_plain(t["x"], t["a"], t["c"], -127.0, t["w"], t["ws"], t["bias"],
                               halo=halo)
    assert torch.equal(o, po) and torch.allclose(s, ps, rtol=1e-5, atol=1e-3)
    o, s, v = k8.res_site_skip(t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], 0.0, t["w"],
                               t["ws"], t["bias"], halo=halo)
    po, ps, pv = k8.res_site_skip_plain(t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], 0.0,
                                        t["w"], t["ws"], t["bias"], halo=halo)
    assert torch.equal(o, po) and torch.equal(v, pv)
    assert torch.allclose(s, ps, rtol=1e-5, atol=1e-3)
    expect = {"res_site": 1, "res_site_skip": 1}
    if c == co:
        q = k8.res_site_s8o(t["x"], t["a"], t["c"], -127.0, t["w"], t["ws"], t["bias"],
                            t["qa"], t["qc"], halo=halo)
        assert torch.equal(q, k8.res_site_s8o_plain(t["x"], t["a"], t["c"], -127.0, t["w"],
                                                    t["ws"], t["bias"], t["qa"], t["qc"],
                                                    halo=halo))
        aa, ac = t["qa"] / 40, t["qc"] / 40
        o = k8.site_s8(t["codes"], t["w"], t["ws"], t["bias"], aa, ac, t["y"], halo=halo)
        assert torch.equal(o, k8.site_s8_plain(t["codes"], t["w"], t["ws"], t["bias"], aa, ac,
                                               t["y"], halo=halo))
        expect.update(res_site_s8o=1, site_s8=1)
    torch.cuda.synchronize()
    assert {k: k8.LAUNCHES[k] - before[k] for k in expect} == expect


@pytest.mark.cuda
@pytest.mark.parametrize("c,co,halo", [(128, 256, "edge"), (64, 128, "edge"),
                                       (128, 128, "reflect")])
def test_k3_s8out_yaff_match_plain_on_card(cuda_device, c, co, halo):
    """K3's S8OUT (per-channel rows, floor 0 or −127) and YAFF epilogues,
    and the bare bf16 form, against the plain version: bit-identical."""
    t = _int8_inputs(cuda_device, c, co)
    before = k8.LAUNCHES["site_s8"]
    cases = [dict(qa=t["qa"], qc=t["qc"], qlo=0.0), {}]
    if c == co:
        aa, ac = t["qa"] / 40, t["qc"] / 40
        cases += [dict(aa=aa, ac=ac, y=t["y"], qa=t["qa"] / 4, qc=t["qc"], qlo=-127.0),
                  dict(aa=aa, ac=ac, y=t["y"], yaff=(t["a2"][0], t["c2"][0]))]
    for kw in cases:
        o = k8.site_s8(t["codes"], t["w"], t["ws"], t["bias"], halo=halo, **kw)
        assert torch.equal(o, k8.site_s8_plain(t["codes"], t["w"], t["ws"], t["bias"],
                                               halo=halo, **kw)), sorted(kw)
    torch.cuda.synchronize()
    assert k8.LAUNCHES["site_s8"] - before == len(cases)


def _sums_close(s, ref, n, tol=1e-5):
    """[Σ, Σ²] [B,2,CO] within ``tol`` relative: Σ² of itself, Σ of the
    magnitude sum it could cancel from (at most sqrt(n·Σ²))."""
    s, ref = s.double(), ref.double()
    s2 = ref[:, 1]
    return bool(((s[:, 1] - s2).abs() <= tol * s2).all()
                and ((s[:, 0] - ref[:, 0]).abs() <= tol * (n * s2).sqrt()).all())


# ragged shapes for the tensor-core core (8×16 output tiles, 128 output
# channels a block, one block per SM): H, W off the tile, B ∈ {1, 3}, a
# 128-channel half of 64 (CO = 192), and B·tiles = 189 or 3·117 = 351, not
# multiples of the 132 (CO = 128) or 66 (CO = 256) blocks of an H100's grid
_MMA_SHAPES = [(1, 13, 21, 128, 128, "reflect"), (3, 9, 35, 64, 256, "edge"),
               (3, 70, 100, 128, 256, "reflect"), (3, 70, 200, 64, 128, "edge"),
               (1, 11, 30, 128, 192, "edge"), (1, 8, 16, 64, 64, "reflect")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,halo", _MMA_SHAPES)
def test_k4_tensor_cores_match_plain_on_card(cuda_device, b, h, w, c, co, halo):
    """K4 on the int8 tensor cores against its plain version at ragged
    shapes, both quantize floors: bf16 raw bit-identical, sums within 1e-5;
    two launches bit-identical, sums included; the previous ``__dp4a`` core
    gives the same raw."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + co)
    x, a, cc = t["x"][:1].repeat(b, 1, 1, 1), t["a"][:1].repeat(b, 1), t["c"][:1].repeat(b, 1)
    x[-1] = -x[-1]  # the images differ
    for lo in (-127.0, 0.0):
        args = (x, a, cc, lo, t["w"], t["ws"], t["bias"])
        before = k8.LAUNCHES["res_site"]
        o, s = k8.res_site(*args, halo=halo)
        o2, s2 = k8.res_site(*args, halo=halo)
        prev, _ = k8.res_site_prev(*args, halo=halo)
        po, ps = k8.res_site_plain(*args, halo=halo)
        torch.cuda.synchronize()
        assert k8.LAUNCHES["res_site"] - before == 2
        assert torch.equal(o, po) and torch.equal(prev, po), lo
        assert _sums_close(s, ps, h * w), lo
        assert torch.equal(o, o2) and torch.equal(s, s2), lo


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,halo", _MMA_SHAPES)
def test_k3_tensor_cores_match_plain_on_card(cuda_device, b, h, w, c, co, halo):
    """K3 on the int8 tensor cores against its plain version at ragged
    shapes in every epilogue combination: [frozen affine] × [no residual,
    + y, + activated y (CO == C)] × [bf16 out, s8 emit at floor 0 and −127]:
    bit-identical; two launches bit-identical; the previous ``__dp4a`` core
    agrees."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + co + 1)
    codes = t["codes"][:1].repeat(b, 1, 1, 1)
    codes[-1] = 127 - codes[-1]
    y = torch.randn((b, h, w, co), device=cuda_device).to(torch.bfloat16)
    aa, ac = t["qa"] / 40, t["qc"] / 40
    ya, yc = t["qa"] / 30, t["qc"] / 20
    residuals = [{}] + ([dict(y=y), dict(y=y, yaff=(ya, yc))] if c == co else [])
    outs = [{}, dict(qa=t["qa"] / 4, qc=t["qc"], qlo=0.0), dict(qa=t["qa"] / 4, qc=t["qc"], qlo=-127.0)]
    before = k8.LAUNCHES["site_s8"]
    n = 0
    for aff in ({}, dict(aa=aa, ac=ac)):
        for res in residuals:
            for out in outs:
                kw = dict(halo=halo, **aff, **res, **out)
                args = (codes, t["w"], t["ws"], t["bias"])
                o, o2 = k8.site_s8(*args, **kw), k8.site_s8(*args, **kw)
                ref = k8.site_s8_plain(*args, **kw)
                assert torch.equal(o, ref), sorted(kw)
                assert torch.equal(o, o2) and torch.equal(k8.site_s8_prev(*args, **kw), ref)
                n += 2
    torch.cuda.synchronize()
    assert k8.LAUNCHES["site_s8"] - before == n


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes off a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = buf[1:1 + t.numel()].view(t.shape)
    off.copy_(t)
    return off


def _batch(t, b, flip=False):
    """``t``'s first image repeated b times (the last negated with ``flip``:
    the images differ)."""
    v = t[:1].repeat(b, *([1] * (t.dim() - 1))).contiguous()
    if flip:
        v[-1] = -v[-1]
    return v


# K2 on the tensor-core core at ragged shapes (H off the 8-row tile, W off
# the 16-column tile, B > 1): (B, H, W, C, CO, halo, sw) — every built
# (C, halo): 64 and 128 under the reflect, edge and zero halos (the zero
# halo also at a ragged content width sw), 192 under reflect and edge
_K2_SHAPES = [(3, 13, 21, 128, 128, "reflect", None), (2, 37, 53, 64, 64, "reflect", None),
              (1, 8, 16, 128, 128, "edge", None), (2, 37, 53, 64, 128, "edge", None),
              (3, 13, 32, 128, 128, "zero", 29), (2, 19, 24, 64, 64, "zero", 21),
              (2, 11, 30, 128, 256, "zero", None), (3, 13, 21, 192, 192, "reflect", None),
              (2, 37, 53, 192, 192, "edge", None), (1, 8, 16, 192, 192, "reflect", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,halo,sw", _K2_SHAPES)
def test_k2_tensor_cores_match_plain_on_card(cuda_device, b, h, w, c, co, halo, sw):
    """K2 on the int8 tensor cores against its plain version at ragged
    shapes, both quantize floors; at C = 192 the IN (floor 0) and FRN
    (``qlo`` −127 + ``tau``) emits: codes bit-identical, two launches
    bit-identical, the previous ``__dp4a`` core agrees, the codes of the
    columns >= sw are 0; a misaligned x raises."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + w + co)
    x, a, cc = _batch(t["x"], b, flip=True), _batch(t["a"], b), _batch(t["c"], b)
    emits = [{}]
    if c == 192:
        emits.append(dict(qlo=-127.0, tau=torch.randn(co, device=cuda_device) * 20 - 20))
    before = k8.LAUNCHES["res_site_s8o"]
    n = 0
    for lo in (-127.0, 0.0):
        for emit in emits:
            args = (x, a, cc, lo, t["w"], t["ws"], t["bias"], t["qa"], t["qc"])
            kw = dict(halo=halo, sw=sw, **emit)
            q, q2 = k8.res_site_s8o(*args, **kw), k8.res_site_s8o(*args, **kw)
            ref = k8.res_site_s8o_plain(*args, **kw)
            n += 2
            assert torch.equal(q, ref), (lo, sorted(emit))
            assert torch.equal(q, q2) and torch.equal(k8.res_site_s8o_prev(*args, **kw), ref)
            assert bool((q < 0).any()) == bool(emit)
            if sw is not None:
                assert not q[:, :, sw:].any()
    torch.cuda.synchronize()
    assert k8.LAUNCHES["res_site_s8o"] - before == n
    with pytest.raises(ValueError, match="16-byte"):
        k8.res_site_s8o(_misaligned(x), a, cc, 0.0, t["w"], t["ws"], t["bias"], t["qa"],
                        t["qc"], halo=halo, sw=sw)


# K5 on the tensor-core core at ragged shapes: (B, H, W, C, CO, halo) — 64
# and 128 under the reflect, edge and zero halos, CO = C and CO = 2C (the
# Johnson d1 is 128 -> 256, edge), and 192 (the post-add relu and tau)
_K5_SHAPES = [(3, 13, 21, 128, 128, "reflect"), (2, 37, 53, 64, 64, "reflect"),
              (1, 8, 16, 64, 64, "edge"), (2, 37, 53, 128, 256, "edge"),
              (3, 9, 35, 64, 128, "reflect"), (3, 13, 21, 128, 128, "zero"),
              (2, 11, 30, 64, 64, "zero"), (3, 13, 21, 192, 192, "reflect"),
              (2, 37, 53, 192, 192, "edge"), (1, 8, 16, 192, 192, "reflect")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,halo", _K5_SHAPES)
def test_k5_tensor_cores_match_plain_on_card(cuda_device, b, h, w, c, co, halo):
    """K5 on the int8 tensor cores against its plain version at ragged
    shapes, both quantize floors, ``yout`` on and off; at C = 192 the
    post-add ``relu`` and ``tau``: bf16 raw and v bit-identical, sums within
    1e-5; two launches bit-identical, sums included; the previous ``__dp4a``
    core agrees; a misaligned r2 or yp raises."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + w + co + 1)
    x, y = _batch(t["x"], b, flip=True), _batch(t["y"], b)
    a, cc, a2, c2 = (_batch(t[k], b) for k in ("a", "c", "a2", "c2"))
    acts = [{}] if c != 192 else [
        dict(act="relu"), dict(act="tau", tau_act=torch.randn((b, c), device=cuda_device) * 0.5 - 0.3)]
    before = k8.LAUNCHES["res_site_skip"]
    n = 0
    for lo in (-127.0, 0.0):
        for act in acts:
            for yout in (True, False):
                args = (x, y, a, cc, a2, c2, lo, t["w"], t["ws"], t["bias"])
                kw = dict(halo=halo, yout=yout, **act)
                out, again = k8.res_site_skip(*args, **kw), k8.res_site_skip(*args, **kw)
                prev = k8.res_site_skip_prev(*args, **kw)
                ref = k8.res_site_skip_plain(*args, **kw)
                n += 2
                tag = (lo, sorted(act), yout)
                assert torch.equal(out[0], ref[0]) and torch.equal(prev[0], ref[0]), tag
                assert _sums_close(out[1], ref[1], h * w) and _sums_close(prev[1], ref[1], h * w)
                assert all((p is None and q is None) or torch.equal(p, q)
                           for p, q in zip(out, again)), tag
                if yout:
                    assert torch.equal(out[2], ref[2]) and torch.equal(prev[2], ref[2]), tag
                else:
                    assert out[2] is None and prev[2] is None
    torch.cuda.synchronize()
    assert k8.LAUNCHES["res_site_skip"] - before == n
    args = (a, cc, a2, c2, 0.0, t["w"], t["ws"], t["bias"])
    for r2, yp in ((_misaligned(x), y), (x, _misaligned(y))):
        with pytest.raises(ValueError, match="16-byte"):
            k8.res_site_skip(r2, yp, *args, halo=halo, **acts[0])


# the f32-operand forms: (wrapper, B, H, W, C, CO, halo, form, sw)
_F32_CASES = [("res_site", 3, 13, 21, 128, 128, "reflect", "", None),
              ("res_site", 2, 11, 37, 192, 384, "edge", "", None),
              ("res_site", 1, 9, 30, 64, 64, "zero", "", None),
              ("res_site_skip", 3, 13, 21, 128, 128, "reflect", "", None),
              ("res_site_skip", 2, 9, 35, 192, 192, "reflect", "tau", None),
              ("res_site_skip", 2, 11, 30, 128, 128, "zero", "", None),
              ("res_site_s8o", 3, 13, 21, 128, 128, "reflect", "", None),
              ("res_site_s8o", 2, 9, 35, 192, 192, "reflect", "frn", None),
              ("res_site_s8o", 2, 11, 40, 128, 128, "zero", "", 36),
              ("site_s8", 3, 13, 21, 128, 128, "reflect", "yaff", None),
              ("site_s8", 2, 9, 35, 192, 192, "reflect", "", None),
              ("site_s8", 2, 11, 40, 128, 128, "zero", "", 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,w,c,co,halo,form,sw", _F32_CASES)
def test_f32_forms_match_plain_on_card(cuda_device, name, b, h, w, c, co, halo, form, sw):
    """K2-K5's f32-operand forms (K2's and K4's x, K3's and K5's residual
    f32, not bf16-representable) against their plain versions at ragged
    shapes: codes, bf16 outputs and v bit-identical, sums within 1e-5, two
    launches bit-identical, each counted under its f32 name; the bf16 form
    of the same call counts as before."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + w + c + 7)
    g = torch.Generator(device=cuda_device).manual_seed(h * w)
    f32 = torch.randn((b, h, w, c), generator=g, device=cuda_device)
    rows = {k: _batch(t[k], b) for k in ("a", "c", "a2", "c2")}
    kw = {"halo": halo} if sw is None else {"halo": halo, "sw": sw}
    if name == "res_site":
        args = (f32 * 2, rows["a"], rows["c"], -127.0, t["w"], t["ws"], t["bias"])
    elif name == "res_site_s8o":
        args = (f32 * 2, rows["a"], rows["c"], -127.0, t["w"], t["ws"], t["bias"], t["qa"],
                t["qc"])
        if form == "frn":
            kw.update(qlo=-127.0, tau=torch.randn(co, generator=g, device=cuda_device) * 20 - 20)
    elif name == "res_site_skip":
        args = (_batch(t["x"], b, flip=True), f32, rows["a"], rows["c"], rows["a2"], rows["c2"],
                -127.0, t["w"], t["ws"], t["bias"])
        if form == "tau":
            kw.update(act="tau", tau_act=torch.randn((b, c), generator=g, device=cuda_device))
    else:
        args = (_batch(t["codes"], b), t["w"], t["ws"], t["bias"], t["qa"] / 40, t["qc"] / 40, f32)
        if form == "yaff":
            kw["yaff"] = (t["a2"][0], t["c2"][0])
    key = k8.F32_FORMS[name]
    before, bf16_before = k8.F32_LAUNCHES[key], k8.LAUNCHES[name]
    fn = getattr(k8, name)
    out, again = fn(*args, **kw), fn(*args, **kw)
    ref = getattr(k8, f"{name}_plain")(*args, **kw)
    torch.cuda.synchronize()
    out, again, ref = ((o if isinstance(o, tuple) else (o,)) for o in (out, again, ref))
    for o, a, r in zip(out, again, ref):
        if r is None:
            continue
        assert torch.equal(o, a)
        if o.dtype == torch.float32:
            assert _sums_close(o, r, h * w)
        else:
            assert torch.equal(o, r), (name, o.dtype)
    assert k8.F32_LAUNCHES[key] - before == 2 and k8.LAUNCHES[name] == bf16_before
    with pytest.raises(ValueError, match="no f32 form"):
        k8.res_site(torch.zeros((1, 4, 16, 96), device=cuda_device), rows["a"][:1, :96],
                    rows["c"][:1, :96], -127.0, t["w"], t["ws"], t["bias"])


@pytest.mark.cuda
def test_k2_k5_prev_forms_count_no_launch(cuda_device):
    """``res_site_s8o_prev`` and ``res_site_skip_prev`` count no launch; K2's
    zero halo, like K4's and K5's, is built at C = 64 and 128 only."""
    t = _int8_inputs(cuda_device, 128, 128)
    before = dict(k8.LAUNCHES)
    k8.res_site_s8o_prev(t["x"], t["a"], t["c"], 0.0, t["w"], t["ws"], t["bias"], t["qa"],
                         t["qc"])
    k8.res_site_skip_prev(t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], 0.0, t["w"],
                          t["ws"], t["bias"])
    torch.cuda.synchronize()
    assert k8.LAUNCHES == before
    r = _int8_inputs(cuda_device, 192, 192)
    with pytest.raises(ValueError, match="halo"):
        k8.res_site_s8o(r["x"], r["a"], r["c"], 0.0, r["w"], r["ws"], r["bias"], r["qa"],
                        r["qc"], halo="zero")


# ReCoNet's forms at ragged shapes: (B, H, W, C, CO, halo); at C = 192 the
# tensor-core core stages 64 output channels a block, at 96 its k32 steps are
# odd (27), and the prologue's 16-byte chunks do not divide its 256 threads
_RECO_SHAPES = [(3, 13, 21, 192, 192, "reflect"), (1, 9, 35, 192, 384, "edge"),
                (2, 11, 30, 96, 192, "edge"), (1, 16, 32, 96, 192, "edge")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,halo", _RECO_SHAPES)
def test_reconet_k4_forms_match_plain_on_card(cuda_device, b, h, w, c, co, halo):
    """K4 at ReCoNet's widths, with and without the TLU floor ``tau``:
    bf16 raw bit-identical to the plain version, sums within 1e-5, two
    launches bit-identical."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + c)
    x, a, cc = t["x"][:1].repeat(b, 1, 1, 1), t["a"][:1].repeat(b, 1), t["c"][:1].repeat(b, 1)
    x[-1] = -x[-1]
    tau = torch.randn((b, c), device=cuda_device) * 20 - 10
    for lo, kw in ((0.0, {}), (-127.0, dict(tau=tau))):
        args = (x, a, cc, lo, t["w"], t["ws"], t["bias"])
        before = k8.LAUNCHES["res_site"]
        o, s = k8.res_site(*args, halo=halo, **kw)
        o2, s2 = k8.res_site(*args, halo=halo, **kw)
        po, ps = k8.res_site_plain(*args, halo=halo, **kw)
        torch.cuda.synchronize()
        assert k8.LAUNCHES["res_site"] - before == 2
        assert torch.equal(o, po), sorted(kw)
        assert _sums_close(s, ps, h * w), sorted(kw)
        assert torch.equal(o, o2) and torch.equal(s, s2), sorted(kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(3, 13, 21), (1, 8, 16)])
def test_reconet_k2_k3_k5_forms_match_plain_on_card(cuda_device, b, h, w):
    """At C = 192: K5 with the post-add ``relu`` and ``tau``, K2's IN and
    FRN (``qlo`` −127 + ``tau``) emits, and K3 on each emit's codes (frozen
    affine + residual): bit-identical to the plain versions and across two
    launches; the forms a width is not built for raise."""
    t = _int8_inputs(cuda_device, 192, 192, h=h, w=w, seed=b + h)
    take = lambda v: v[:1].repeat(b, *([1] * (v.dim() - 1))).contiguous()  # noqa: E731
    x, y, a, c, a2, c2 = (take(t[k]) for k in ("x", "y", "a", "c", "a2", "c2"))
    tau_act = torch.randn((b, 192), device=cuda_device) * 0.5 - 0.3
    skip = (x, y, a, c, a2, c2, -127.0, t["w"], t["ws"], t["bias"])
    for kw in (dict(act="relu"), dict(act="tau", tau_act=tau_act)):
        out, again = k8.res_site_skip(*skip, **kw), k8.res_site_skip(*skip, **kw)
        ref = k8.res_site_skip_plain(*skip, **kw)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2]), kw["act"]
        assert _sums_close(out[1], ref[1], h * w), kw["act"]
        assert all(torch.equal(p, q) for p, q in zip(out, again)), kw["act"]
    tauo = torch.randn(192, device=cuda_device) * 20 - 20
    s8o = (x, a, c, -127.0, t["w"], t["ws"], t["bias"], t["qa"], t["qc"])
    aff = (t["qa"] / 40, t["qc"] / 40, y)
    for kw in ({}, dict(qlo=-127.0, tau=tauo)):
        q, q2 = k8.res_site_s8o(*s8o, **kw), k8.res_site_s8o(*s8o, **kw)
        assert torch.equal(q, k8.res_site_s8o_plain(*s8o, **kw)) and torch.equal(q, q2)
        assert bool((q < 0).any()) == bool(kw)
        o = k8.site_s8(q, t["w"], t["ws"], t["bias"], *aff)
        assert torch.equal(o, k8.site_s8_plain(q, t["w"], t["ws"], t["bias"], *aff))
        assert torch.equal(o, k8.site_s8(q, t["w"], t["ws"], t["bias"], *aff))
    torch.cuda.synchronize()
    t64 = _int8_inputs(cuda_device, 128, 128)
    with pytest.raises(ValueError, match="C=128"):  # the floored emit is built at 192 only
        k8.res_site_s8o(t64["x"], t64["a"], t64["c"], -127.0, t64["w"], t64["ws"], t64["bias"],
                        t64["qa"], t64["qc"], qlo=-127.0, tau=t64["qc"])
    with pytest.raises(ValueError, match="C=128"):  # the post-add activation too
        k8.res_site_skip(t64["x"], t64["y"], t64["a"], t64["c"], t64["a2"], t64["c2"], 0.0,
                         t64["w"], t64["ws"], t64["bias"], act="relu")
    with pytest.raises(ValueError, match="C=128"):  # and K4's floor
        k8.res_site(t64["x"], t64["a"], t64["c"], -127.0, t64["w"], t64["ws"], t64["bias"],
                    tau=t64["a"])


# K8a and K8b on the int8 tensor cores (8×16 output tiles): (name, C, CO, B,
# H, W); each also with a partial last tile row and column at B = 3 and a
# one-tile image; B·tiles below the persistent grid: K8a 3·(7·7) = 147 over
# its 264 blocks, K8b 3·(4·4) = 48 over its 132 (one block an SM)
_K8_CASES = [("c2_site", 32, 64, 2, 38, 74), ("c3_site", 64, 128, 2, 38, 74),
             ("c2_site", 32, 64, 3, 50, 98), ("c2_site", 32, 64, 1, 16, 32),
             ("c2_site", 32, 64, 3, 112, 224), ("c3_site", 64, 128, 3, 50, 98),
             ("c3_site", 64, 128, 1, 16, 32), ("c3_site", 64, 128, 3, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,c,co,b,h,w", _K8_CASES)
def test_k8_head_sites_match_plain_on_card(cuda_device, name, c, co, b, h, w):
    """K8a/K8b (stride-2 3×3, pixel reflect halo) at the floors 0 and −127:
    bf16 raw bit-identical to the plain version and to the previous
    ``__dp4a`` design, sums within 1e-5, two launches bit-identical; the
    previous design counts no launch and a misaligned x raises."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w)
    x, a, cc = (t[k] if b == 2 else _batch(t[k], b, flip=k == "x") for k in ("x", "a", "c"))
    before = dict(k8.LAUNCHES)
    n = 0
    for lo in (0.0, -127.0):
        args = (x, a, cc, lo, t["w"], t["ws"], t["bias"])
        o, s = getattr(k8, name)(*args)
        po, ps = getattr(k8, f"{name}_plain")(*args)
        o2, s2 = getattr(k8, name)(*args)
        prev, sprev = getattr(k8, f"{name}_prev")(*args)
        n += 2
        torch.cuda.synchronize()
        assert tuple(o.shape) == (b, h // 2, w // 2, co)
        assert torch.equal(o, po) and torch.allclose(s, ps, rtol=1e-5, atol=1e-3), lo
        assert torch.equal(o, o2) and torch.equal(s, s2), lo
        assert torch.equal(prev, o) and _sums_close(sprev, ps, (h // 2) * (w // 2)), lo
    torch.cuda.synchronize()
    assert k8.LAUNCHES == {**before, name: before[name] + n}
    with pytest.raises(ValueError, match="16-byte"):
        getattr(k8, name)(_misaligned(x), a, cc, 0.0, t["w"], t["ws"], t["bias"])


# K6 on the int8 tensor cores (warps walk 32-column strips down the image):
# (B, H, W); partial last strips, a one-strip image shorter than the 5-row
# dy-sum, B = 3, and 3·4·75 = 900 output rows over 64 warps, whose shares
# start and end inside strips
_D3_CASES = [(2, 12, 16), (2, 19, 37), (3, 19, 70), (1, 3, 13), (1, 7, 32), (3, 75, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", _D3_CASES)
def test_k6_k7_d3_sites_match_plain_on_card(cuda_device, b, h, w):
    """K7 (quantize → 1×5 rows, 60 lanes) and K6 (s8 codes → rows → dy-sum
    + bias) against their plain versions: bit-identical. K6 also
    bit-identical to its previous ``__dp4a`` design, two launches
    bit-identical; the previous design counts no launch and a misaligned
    xq raises."""
    rng = np.random.default_rng(h if b == 2 else [b, h, w])  # B = 2: the cases' old seeds
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    w5 = torch.from_numpy(rng.integers(-127, 128, (1, 5, 128, 60)).astype(np.int8))
    wk = k8.pack_weights(w5, co_pad=64).to(cuda_device)
    ws = f32(np.concatenate([rng.uniform(0.5, 2, 60) / (127 * 127 * 20), np.zeros(4)]))
    y = f32(rng.normal(0, 2, (b, h, w, 128))).to(torch.bfloat16)
    a, c = f32(rng.uniform(5, 40, (b, 128))), f32(rng.normal(0, 8, (b, 128)))
    codes = torch.from_numpy(rng.integers(0, 128, (b, h, w, 128)).astype(np.int8)).to(cuda_device)
    bias = f32(rng.normal(0, 0.2, 12))
    before = dict(k8.LAUNCHES)
    rows = k8.d3_rows_site(y, a, c, wk, ws)
    out, again = k8.d3_s8_site(codes, wk, ws, bias), k8.d3_s8_site(codes, wk, ws, bias)
    prev = k8.d3_s8_site_prev(codes, wk, ws, bias)
    torch.cuda.synchronize()
    assert tuple(rows.shape) == (b, h, w, 60) and tuple(out.shape) == (b, h, w, 12)
    assert torch.equal(rows, k8.d3_rows_site_plain(y, a, c, wk, ws))
    assert torch.equal(out, k8.d3_s8_site_plain(codes, wk, ws, bias))
    assert torch.equal(out, again) and torch.equal(out, prev)
    assert k8.LAUNCHES == {**before, "d3_rows_site": before["d3_rows_site"] + 1,
                           "d3_s8_site": before["d3_s8_site"] + 2}
    with pytest.raises(ValueError, match="16-byte"):
        k8.d3_s8_site(_misaligned(codes), wk, ws, bias)


@pytest.mark.cuda
def test_int8_wrappers_reject_bad_inputs(cuda_device):
    t = _int8_inputs(cuda_device, 128, 128)
    args = (t["a"], t["c"], -127.0, t["w"], t["ws"], t["bias"])
    with pytest.raises(ValueError, match="contiguous"):
        k8.res_site(t["x"].transpose(1, 2), *args)
    with pytest.raises(TypeError, match="bf16 or f32"):
        k8.res_site(t["x"].half(), *args)
    with pytest.raises(ValueError, match="no f32 form at C=64"):  # f32 x: the f32 form's counts
        k8.res_site(t["x"][..., :64].float().contiguous(), t["a"][:, :64], t["c"][:, :64],
                    -127.0, t["w"][:, :16], t["ws"], t["bias"])
    with pytest.raises(ValueError, match="expected cuda"):
        k8.res_site(t["x"], t["a"].cpu(), *args[1:])
    with pytest.raises(ValueError, match="C=96"):
        k8.res_site(t["x"][..., :96].contiguous(), *args)
    shifted = torch.empty(t["x"].numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        k8.res_site(shifted[1:].view(t["x"].shape), *args)


def _bf16_site_args(device, name, shape, seed=0):
    """Operands of a bf16 site at realistic scales."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    b, _, _, c = shape
    args = [f32(rng.normal(0, 1.5, shape)).to(torch.bfloat16),
            f32(rng.uniform(0.5, 1.5, (b, c))), f32(rng.normal(0, 0.3, (b, c)))]
    if name.startswith("d3"):
        args.append(k9.pack_rows_weights(f32(rng.normal(0, 640 ** -0.5, (1, 5, 128, 60)))))
        if name == "d3_sum_site":
            args.append(f32(rng.normal(0, 0.2, 12)))
    else:
        co = k9.SITES[name][1]
        args += [k9.pack_site_weights(f32(rng.normal(0, (9 * c) ** -0.5, (3, 3, c, co)))),
                 f32(rng.normal(0, 0.2, co))]
    return args


# K9b on the bf16 tensor cores walks 16-column strips down the image: partial
# strips (37, 70 columns), a one-strip image shorter than the 5-row dy-sum
# (3 × 13), B = 3, and 3·75·7 = 1575 strip rows over 13 blocks of 8 warps,
# whose shares start and end inside strips
@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("d2_site", (2, 19, 37, 64)), ("d2_site", (1, 28, 32, 64)),
                                        ("c2_site_bf16", (2, 38, 74, 32)),
                                        ("c3_site_bf16", (2, 38, 74, 64)),
                                        ("d3_rows", (2, 19, 37, 128)),
                                        ("d3_sum_site", (2, 19, 37, 128)),
                                        ("d3_sum_site", (1, 28, 32, 128)),
                                        ("d3_sum_site", (1, 3, 13, 128)),
                                        ("d3_sum_site", (3, 19, 70, 128)),
                                        ("d3_sum_site", (3, 75, 100, 128))])
def test_k9_bf16_sites_match_plain_on_card(cuda_device, name, shape):
    """K9a-K9e against their plain versions on the card, at sizes that leave
    partial tiles: two launches bit-identical; bf16 outputs within 1 ulp (an
    ulp taken at no less than 2^-8 of the largest magnitude: the two differ
    by the order of their f32 accumulation; K9b within 2 ulp of its largest
    row term) and 99% equal; sums within 1e-5. K9b also against its
    previous core, which counts no launch, within the same bounds."""
    args = _bf16_site_args(cuda_device, name, shape)
    before = dict(k9.LAUNCHES)
    out, again = getattr(k9, name)(*args), getattr(k9, name)(*args)
    ref = getattr(k9, f"{name}_plain")(*args)
    prev = k9.d3_sum_site_prev(*args) if name == "d3_sum_site" else None
    torch.cuda.synchronize()
    assert k9.LAUNCHES == {**before, name: before[name] + 2}
    outs, agains, refs = (t if isinstance(t, tuple) else (t,) for t in (out, again, ref))
    assert all(torch.equal(a, b) for a, b in zip(outs, agains))
    o, r = outs[0], refs[0]
    assert o.dtype == torch.bfloat16 and o.shape == r.shape
    scale, limit = None, 1.0
    if name == "d3_sum_site":
        scale, limit = k9.d3_sum_scale_plain(*args[:4]), 2.0
    worst, equal = k9.bf16_ulp_error(o, r, scale=scale)
    assert worst <= limit and equal >= 0.99, (worst, equal)
    if prev is not None:
        worst, equal = k9.bf16_ulp_error(o, prev, scale=scale)
        assert worst <= limit and equal >= 0.99, ("prev", worst, equal)
        with pytest.raises(ValueError, match="16-byte"):
            k9.d3_sum_site(_misaligned(args[0]), *args[1:])
    if len(outs) > 1:
        n = o.shape[1] * o.shape[2]
        s, sr = outs[1].double(), refs[1].double()
        assert bool(((s[:, 1] - sr[:, 1]).abs() <= 1e-5 * sr[:, 1]).all())
        assert bool(((s[:, 0] - sr[:, 0]).abs() <= 1e-5 * (n * sr[:, 1]).sqrt()).all())


@pytest.mark.cuda
def test_bf16_wrappers_reject_bad_inputs(cuda_device):
    x, a, c, w, bias = _bf16_site_args(cuda_device, "d2_site", (2, 19, 37, 64))
    with pytest.raises(ValueError, match="contiguous"):
        k9.d2_site(x.transpose(1, 2), a, c, w, bias)
    with pytest.raises(TypeError, match="bfloat16"):
        k9.d2_site(x.float(), a, c, w, bias)
    with pytest.raises(ValueError, match="expected cuda"):
        k9.d2_site(x, a.cpu(), c, w, bias)
    with pytest.raises(ValueError, match="C=64"):
        k9.c2_site_bf16(x, a, c, w, bias)
    with pytest.raises(ValueError, match="even size"):
        k9.c3_site_bf16(x, a, c, w, bias)


def test_k9_cpu_tensors_take_the_plain_version():
    args = _bf16_site_args("cpu", "d3_sum_site", (1, 6, 8, 128))
    before = dict(k9.LAUNCHES)
    out = k9.d3_sum_site(*args)
    assert k9.LAUNCHES == before
    assert torch.equal(out, k9.d3_sum_site_plain(*args)) and tuple(out.shape) == (1, 6, 8, 12)


def _random_johnson(seed=0):
    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.models.transformer_net import TransformerNet

    torch.manual_seed(seed)
    net = TransformerNet().eval().requires_grad_(False)
    return tst.StyleModel("johnson", net, "raw_01", "init")


def _on(model, device):
    import copy

    from neuralstyletransferv1_torch.engine import stylizer as tst

    return tst.StyleModel(model.arch, copy.deepcopy(model.net).to(device), model.io_preset,
                          model.name)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize,fused,expect", [
    ("none", ("head", "tail"), {"c2_site_bf16": 1, "c3_site_bf16": 1, "d2_site": 1,
                                "d3_sum_site": 1}),
    ("none", ("d3",), {"d3_rows": 1}),
    ("int8", ("res_i8", "tail"), {"d2_site": 1, "d3_sum_site": 1}),
])
def test_fused_sites_stylize_card_vs_cpu(cuda_device, quantize, fused, expect):
    """The bf16 fused sites through ``jit_stylizer`` at 56×64 (partial tiles
    in every kernel) on the card against the CPU path on the plain versions:
    within the 1e-2 gate, each kernel launched once."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    model = _random_johnson()
    x = torch.from_numpy(np.random.default_rng(3).random((2, 56, 64, 3), np.float32))
    ref = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=quantize, fused_sites=fused)(x)
    before = dict(k9.LAUNCHES)
    got = tst.jit_stylizer(_on(model, cuda_device), dtype=torch.bfloat16, quantize=quantize,
                           fused_sites=fused)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in k9.LAUNCHES.items() if v != before[k]} == expect
    assert float((got.cpu() - ref).abs().mean()) <= 1e-2
    assert float(got.std()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_below_gate_int8_sites_run_on_card(cuda_device, quantize):
    """24×48 is below the res and decoder gates: the int8 sites run in
    PyTorch ops on the card too (no kernel launch), within 5e-2 of the CPU
    run (a flipped code moves this random-weight net; the gate is 1e-2)."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    model = _random_johnson(1)
    x = torch.from_numpy(np.random.default_rng(4).random((1, 24, 48, 3), np.float32))
    ref = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=quantize)(x)
    before = dict(k8.LAUNCHES)
    got = tst.jit_stylizer(_on(model, cuda_device), dtype=torch.bfloat16, quantize=quantize)(
        x.to(cuda_device))
    torch.cuda.synchronize()
    assert k8.LAUNCHES == before
    assert float((got.cpu() - ref).abs().mean()) <= 5e-2


# the NST chain's zero-halo, sw-masked forms at ragged shapes: (B, H, W, C,
# CO, sw) — the content width sw under the %8-padded W, a ragged sw (29 of
# 32), partial 8×16 tiles, and the aligned control without a mask
_ZERO_SW_SHAPES = [(1, 13, 32, 128, 128, 29), (3, 9, 40, 128, 128, 36),
                   (2, 19, 24, 64, 64, 21), (1, 16, 48, 128, 128, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,sw", _ZERO_SW_SHAPES)
def test_k2_k3_zero_halo_sw_match_plain_on_card(cuda_device, b, h, w, c, co, sw):
    """K2 and K3 with the zero halo and the content-width mask sw against
    their plain versions: codes and bf16 bit-identical (K3 as the NST chain
    runs it — frozen affine + residual — and with the s8 emit); two launches
    bit-identical; the previous ``__dp4a`` core of K3 agrees; the masked
    columns' codes are 0."""
    t = _int8_inputs(cuda_device, c, co, h=h, w=w, seed=h + w)
    x = t["x"].repeat(2, 1, 1, 1)[:b].contiguous()
    a, cc = t["a"].repeat(2, 1)[:b].contiguous(), t["c"].repeat(2, 1)[:b].contiguous()
    kargs = (x, a, cc, -127.0, t["w"], t["ws"], t["bias"], t["qa"], t["qc"])
    before = dict(k8.LAUNCHES)
    q = k8.res_site_s8o(*kargs, halo="zero", sw=sw)
    assert torch.equal(q, k8.res_site_s8o(*kargs, halo="zero", sw=sw))
    assert torch.equal(q, k8.res_site_s8o_plain(*kargs, halo="zero", sw=sw))
    if sw is not None:
        assert not q[:, :, sw:].any()
    y = torch.randn((b, h, w, co), device=cuda_device).to(torch.bfloat16)
    aa, ac = t["qa"] / 40, t["qc"] / 40
    forms = [dict(aa=aa, ac=ac, y=y), dict(aa=aa, ac=ac, y=y, qa=t["qa"] / 4, qc=t["qc"],
                                           qlo=-127.0), dict(qa=t["qa"] / 4, qc=t["qc"])]
    for kw in forms:
        args = (q, t["w"], t["ws"], t["bias"])
        o = k8.site_s8(*args, halo="zero", sw=sw, **kw)
        ref = k8.site_s8_plain(*args, halo="zero", sw=sw, **kw)
        assert torch.equal(o, ref), sorted(kw)
        assert torch.equal(o, k8.site_s8(*args, halo="zero", sw=sw, **kw))
        assert torch.equal(k8.site_s8_prev(*args, halo="zero", sw=sw, **kw), ref)
        if "qa" in kw and sw is not None:
            assert not o[:, :, sw:].any()
    torch.cuda.synchronize()
    assert k8.LAUNCHES["res_site_s8o"] - before["res_site_s8o"] == 2
    assert k8.LAUNCHES["site_s8"] - before["site_s8"] == 2 * len(forms)


@pytest.mark.cuda
def test_zero_halo_reaches_only_k2_k3(cuda_device):
    """The zero halo's boundary (the name predates K4/K5's zero forms): K2–K5
    take it — K4 and K5 at C = 64/128 and without a floor (K4's ``tau``, K5's
    ``act`` keep reflect/edge) — and the stride-2 head sites K8a/K8b have no
    halo choice; ``sw`` needs the zero halo."""
    t = _int8_inputs(cuda_device, 128, 128)
    k4 = (t["x"], t["a"], t["c"], -127.0, t["w"], t["ws"], t["bias"])
    k5 = (t["x"], t["y"], t["a"], t["c"], t["a2"], t["c2"], -127.0, t["w"], t["ws"], t["bias"])
    k8.res_site(*k4, halo="zero")
    k8.res_site_skip(*k5, halo="zero")
    k8.res_site_s8o(*k4, t["qa"], t["qc"], halo="zero")
    k8.site_s8(t["codes"], t["w"], t["ws"], t["bias"], halo="zero")
    r = _int8_inputs(cuda_device, 192, 192)
    with pytest.raises(ValueError, match="halo"):
        k8.res_site(r["x"], r["a"], r["c"], -127.0, r["w"], r["ws"], r["bias"], halo="zero",
                    tau=r["a"])
    with pytest.raises(ValueError, match="halo"):
        k8.res_site_skip(r["x"], r["y"], r["a"], r["c"], r["a2"], r["c2"], -127.0, r["w"],
                         r["ws"], r["bias"], halo="zero", act="relu")
    h = _int8_inputs(cuda_device, 32, 64, h=20, w=36)
    with pytest.raises(TypeError, match="halo"):
        k8.c2_site(h["x"], h["a"], h["c"], 0.0, h["w"], h["ws"], h["bias"], halo="zero")
    with pytest.raises(ValueError, match="sw="):
        k8.site_s8(t["codes"], t["w"], t["ws"], t["bias"], halo="reflect", sw=8)


# ragged shapes for K4's and K5's zero halo: H, W off the 8×16 tile, B = 3
_ZERO_SHAPES = [(3, 13, 21, 128), (1, 11, 30, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", _ZERO_SHAPES)
def test_k4_k5_zero_halo_match_plain_on_card(cuda_device, b, h, w, c):
    """K4 (``mma_kernel``, and its previous ``__dp4a`` core) and K5
    (``mma_kernel``) with ``halo="zero"`` against their plain versions, both
    floors, a nonzero ``c`` (so that the halo's code 0 differs from the
    quantized zero): bf16 raw and K5's v bit-identical, sums within 1e-5;
    two launches bit-identical, sums included."""
    t = _int8_inputs(cuda_device, c, c, h=h, w=w, seed=h + c)
    x, y = t["x"][:1].repeat(b, 1, 1, 1), t["y"][:1].repeat(b, 1, 1, 1)
    a, cc = t["a"][:1].repeat(b, 1), t["c"][:1].repeat(b, 1)
    x[-1] = -x[-1]  # the images differ
    assert bool((torch.round(cc) != 0).any())
    for lo in (-127.0, 0.0):
        args = (x, a, cc, lo, t["w"], t["ws"], t["bias"])
        before = dict(k8.LAUNCHES)
        o, s = k8.res_site(*args, halo="zero")
        o2, s2 = k8.res_site(*args, halo="zero")
        prev, _ = k8.res_site_prev(*args, halo="zero")
        po, ps = k8.res_site_plain(*args, halo="zero")
        skip = (x, y, a, cc, t["a2"][:1].repeat(b, 1), t["c2"][:1].repeat(b, 1), lo, t["w"],
                t["ws"], t["bias"])
        ko, ks, kv = k8.res_site_skip(*skip, halo="zero")
        ko2, ks2, kv2 = k8.res_site_skip(*skip, halo="zero")
        pko, pks, pkv = k8.res_site_skip_plain(*skip, halo="zero")
        torch.cuda.synchronize()
        assert {k: k8.LAUNCHES[k] - before[k] for k in ("res_site", "res_site_skip")} == \
            {"res_site": 2, "res_site_skip": 2}
        assert torch.equal(o, po) and torch.equal(prev, po), lo
        assert _sums_close(s, ps, h * w), lo
        assert torch.equal(o, o2) and torch.equal(s, s2), lo
        assert torch.equal(ko, pko) and torch.equal(kv, pkv), lo
        assert _sums_close(ks, pks, h * w), lo
        assert torch.equal(ko, ko2) and torch.equal(ks, ks2) and torch.equal(kv, kv2), lo
        # the reflect halo gives another raw: the border codes are not copies
        assert not torch.equal(k8.res_site(*args, halo="reflect")[0], o), lo


@pytest.mark.cuda
def test_t7_bn_res_i8_chain_card_vs_cpu(cuda_device):
    """A BN-folded Torch7 graph's res chain forced onto ``res_i8`` (6 × K4 +
    4 × K5, zero halo; its quantize affines are constants, so no sum order
    enters the codes) on the card and on the CPU from one res-chain input:
    bit-identical, and bit-identical to the PyTorch-int8 chain."""
    import chip_smoke
    from neuralstyletransferv1_torch.io import t7_fast as tf

    p32 = tf.try_fast_johnson(chip_smoke.t7_net_layers(4, "bn", c0=16))
    x = torch.from_numpy(np.random.default_rng(3).random((2, 64, 96, 3), np.float32))
    xin = x.flip(-1) * 255.0 - torch.tensor([103.939, 116.779, 123.68])
    quant = tf.quantize_t7(p32, tf.calibrate_t7_scales(p32, xin))
    grab = {}
    pb = tf.params_to(p32, "cpu", torch.bfloat16)
    with torch.no_grad():
        tf.t7_fast_apply(pb, xin.to(torch.bfloat16),
                         tap=lambda site, t: grab.setdefault(site, t.contiguous()))
        outs = []
        for d in (cuda_device, torch.device("cpu")):
            p_d = tf.params_to(pb, d, torch.bfloat16)
            sites = tf.prepare_sites(p_d, quant, d)
            before = dict(k8.LAUNCHES)
            outs.append(tf._t7_res_chain_i8(grab["r0a"].to(d), p_d["res"], sites).cpu())
            if d.type == "cuda":
                torch.cuda.synchronize()
                assert {k: k8.LAUNCHES[k] - before[k] for k in ("res_site", "res_site_skip")} \
                    == {"res_site": 6, "res_site_skip": 4}
        xla = tf._t7_res_quant_xla(grab["r0a"], pb["res"], tf.prepare_sites(pb, quant, "cpu"))
    assert grab["r0a"].shape == (2, 16, 24, 64)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], xla)


# the stylize each NST mode is gated against, with the same norms (as
# tests/test_static_norm.py gates the JAX NST int8_static)
_NST_BASE = {"int8_static": "bf16_static", "int8": "none"}


@pytest.mark.cuda
@pytest.mark.parametrize("quantize,launches", [("int8_static", 5), ("int8", 0), ("none", 0)])
def test_nst_stylize_card_vs_cpu(cuda_device, quantize, launches):
    """An NST slot through ``jit_stylizer`` (bf16) at 48×64 (res grid 32 ×
    36, sw = 36) on the card: int8_static launches K2 and K3 five times
    each; a quantized stylize is within the 1e-2 gate of the card's bf16
    stylize with the same norms; against the CPU path within 1e-2 unquantized
    and 5e-2 quantized — cuDNN's and the CPU's bf16 convs differ by ulps,
    which flip int8 codes that this random net amplifies (the chain itself
    is bit-identical, ``test_nst_s8_chain_card_vs_cpu``)."""
    from neuralstyletransferv1_torch.engine import stylizer as tst

    model = tst.make_random_model("nst", seed=2)
    x = torch.from_numpy(np.random.default_rng(5).random((2, 48, 64, 3), np.float32))
    ref = tst.jit_stylizer(model, dtype=torch.bfloat16, quantize=quantize)(x)
    card = _on(model, cuda_device)
    before = dict(k8.LAUNCHES)
    got = tst.jit_stylizer(card, dtype=torch.bfloat16, quantize=quantize)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in k8.LAUNCHES.items() if v != before[k]} == (
        {"res_site_s8o": launches, "site_s8": launches} if launches else {})
    assert float((got.cpu() - ref).abs().mean()) <= (1e-2 if quantize == "none" else 5e-2)
    assert float(got.std()) > 0.05
    if quantize in _NST_BASE:
        base = tst.jit_stylizer(card, dtype=torch.bfloat16, quantize=_NST_BASE[quantize])(
            x.to(cuda_device))
        assert float((got - base).abs().mean()) <= 1e-2


@pytest.mark.cuda
def test_nst_s8_chain_card_vs_cpu(cuda_device):
    """The NST int8_static res chain (5 × K2 + 5 × K3, zero halo, the res
    width 36 padded to 40 with sw = 36) on the card and on the CPU from one
    res-chain input and one calibration: bit-identical."""
    import copy

    from neuralstyletransferv1_torch.engine import stylizer as tst
    from neuralstyletransferv1_torch.models import transformer_net_nst_fast as nstf

    net = tst.make_random_model("nst", seed=3).net
    x = torch.from_numpy(np.random.default_rng(6).random((2, 48, 64, 3), np.float32))
    stats = nstf.calibrate_in_stats(net, x[:1])
    quant = nstf.quantize_net(net, nstf.calibrate_act_scales(net, x[:1], static_stats=stats))
    nb = copy.deepcopy(net).to(torch.bfloat16)
    grab = {}
    with torch.no_grad():
        nstf.apply(nb, x.to(torch.bfloat16), static_stats=stats,
                   tap=lambda site, t: grab.setdefault(site, t.contiguous()))
        outs = []
        for d in (cuda_device, torch.device("cpu")):
            net_d = copy.deepcopy(nb).to(d)
            st_d = {k: (m.to(d), inv.to(d)) for k, (m, inv) in stats.items()}
            outs.append(nstf.res_chain_s8_static(grab["r1a"].to(d), net_d,
                                                 nstf.prepare_sites(net_d, quant, d), st_d).cpu())
    assert grab["r1a"].shape == (2, 32, 36, 128)
    assert torch.equal(*outs)
