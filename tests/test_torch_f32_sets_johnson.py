"""Part of the fused-site sets under f32 params in the PyTorch port against the
JAX package on the CPU: Johnson's ``head_i8`` s8 set ending in ``tail_s8``, and
the two sets whose ``head_i8`` meets an f32 conv (the port raises, naming the
JAX forward's TypeError). Each set of the map of PERF.md section 6
(``torch_f32_nets.F32_MAP``) is held by ``check_set`` to the JAX forward with
its Pallas sites in interpret mode: its dtype, within its MAE bound on the
[0, 1] frame, or its TypeError. ``torch_f32_nets.F32_PARTS`` splits the map
over tests/test_torch_f32_sets_*.py so that each file's worker stays near 30 s
in the six-worker tier-1 run; the kernels run on the card
(tests/test_torch_f32_forms_card.py, tests/test_torch_k7_f32.py).
"""

from pathlib import Path

import pytest
from torch_f32_nets import F32_MAP, F32_PARTS, check_set, one_thread  # noqa: F401


@pytest.mark.parametrize("name", F32_PARTS["johnson"])
def test_f32_set_matches_jax(name):
    check_set(name)


def test_f32_parts_cover_the_map():
    """Every set of the map is run by exactly one of the files, and each
    part names its file."""
    names = [n for part in F32_PARTS.values() for n in part]
    assert sorted(names) == sorted(F32_MAP) and len(set(names)) == len(names)
    stems = {p.stem.removeprefix("test_torch_f32_sets_")
             for p in Path(__file__).parent.glob("test_torch_f32_sets_*.py")}
    assert stems == set(F32_PARTS)
