"""Rules of the PyTorch port: no JAX at run time, no CPU fallback on the
CUDA path, and K1's kernel against its plain version on the card.

The JAX-import rule is checked statically (an AST scan), since the test
process itself imports jax.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from neuralstyletransferv1_torch.kernels import dis_iter as k1

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "neuralstyletransferv1_torch"
ALLOWED_TPU_MODULES = {"io.checkpoints", "engine.config", "io.frames"}


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
            if top in ("jax", "jaxlib", "flax"):
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
    assert not mods & {"jax", "jaxlib", "neuralstyletransferv1_tpu"}


def test_scan_catches_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\n"
                   "from neuralstyletransferv1_tpu.ops import warp\n"
                   "from neuralstyletransferv1_tpu.io import checkpoints\n")
    assert [b[1] for b in _scan([bad])] == ["jax.numpy", "neuralstyletransferv1_tpu.ops"]


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
