"""Part of the fused-site sets under f32 params in the PyTorch port against the
JAX package on the CPU: Johnson's ``head_i8`` + ``res_i8`` set ending in
``tail_s8``, ``dec_s8`` + ``tail_s8``, and ``d3_i8`` on the XLA-form decoder
(K7's f32 form on the f32 d2 raw, the border strips in f32). Each set of the
map of PERF.md section 6 (``torch_f32_nets.F32_MAP``) is held by ``check_set``
to the JAX forward with its Pallas sites in interpret mode: its dtype, within
its MAE bound on the [0, 1] frame, or its TypeError.
``torch_f32_nets.F32_PARTS`` splits the map over tests/test_torch_f32_sets_*.py
so that each file's worker stays near 30 s in the six-worker tier-1 run; the
kernels run on the card (tests/test_torch_f32_forms_card.py,
tests/test_torch_k7_f32.py).
"""

import pytest
from torch_f32_nets import F32_PARTS, check_set, one_thread  # noqa: F401


@pytest.mark.parametrize("name", F32_PARTS["johnson_2"])
def test_f32_set_matches_jax(name):
    check_set(name)
