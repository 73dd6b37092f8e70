"""Johnson's fused-site sets under f32 params in the PyTorch port against
the JAX package on the CPU, set by set as the map of PERF.md section 6 lists
them (``torch_f32_nets.F32_MAP``, whose ``check_set`` holds each to the JAX
forward with its Pallas sites in interpret mode: its dtype, within the
repo's 1e-2 gate on [0, 1], or its TypeError). The NST_Train, Torch7 and
ReCoNet sets are tests/test_torch_f32_sets_nets.py's: the two files split
the map so that the six-worker tier-1 run spreads it; the kernels run on the
card (``tests/test_torch_f32_forms_card.py``).
"""

import pytest
from torch_f32_nets import F32_MAP, check_set, one_thread  # noqa: F401


@pytest.mark.parametrize("name", [n for n in F32_MAP if n.startswith("johnson")])
def test_f32_set_matches_jax(name):
    check_set(name)
