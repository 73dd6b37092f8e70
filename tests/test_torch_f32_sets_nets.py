"""The NST_Train, Torch7 (IN, BN) and ReCoNet (IN, FRN) fused-site sets under
f32 params in the PyTorch port against the JAX package on the CPU, set by
set as the map of PERF.md section 6 lists them (``torch_f32_nets.F32_MAP``,
whose ``check_set`` holds each to the JAX forward with its Pallas sites in
interpret mode: its dtype, within the repo's 1e-2 gate on [0, 1], or within
1e-5 where the port runs JAX's Pallas chains on JAX's own inputs). They
reach the new float32 forms: K4's 2×2 forms on conv2's and deconv1's f32
inputs, K2 at CO = 384 on ReCoNet's f32 res output. Johnson's sets are
tests/test_torch_f32_sets_johnson.py's; the kernels run on the card
(``tests/test_torch_f32_forms_card.py``).
"""

import pytest
from torch_f32_nets import F32_MAP, check_set, one_thread  # noqa: F401


@pytest.mark.parametrize("name", [n for n in F32_MAP if not n.startswith("johnson")])
def test_f32_set_matches_jax(name):
    check_set(name)
