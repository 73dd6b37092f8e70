"""Part of the fused-site sets under f32 params in the PyTorch port against the
JAX package on the CPU: NST_Train's ``c2_i8`` + ``res_i8`` + ``dec_i8`` and
``c2_i8`` + ``dec_i8`` sets. Each set of the map of PERF.md section 6
(``torch_f32_nets.F32_MAP``) is held by ``check_set`` to the JAX forward with
its Pallas sites in interpret mode: its dtype, within its MAE bound on the
[0, 1] frame, or its TypeError. ``torch_f32_nets.F32_PARTS`` splits the map
over tests/test_torch_f32_sets_*.py so that each file's worker stays near 30 s
in the six-worker tier-1 run; the kernels run on the card
(tests/test_torch_f32_forms_card.py, tests/test_torch_k7_f32.py).
"""

import pytest
from torch_f32_nets import F32_PARTS, check_set, one_thread  # noqa: F401


@pytest.mark.parametrize("name", F32_PARTS["nets_2"])
def test_f32_set_matches_jax(name):
    check_set(name)
