"""Where the Gram NST's f32 runs part from an f64 run of the same ten Adam
steps (``experiments/gram_parting.py``), on the CPU: the measurement behind
the gate of ``tests/test_torch_ladder_card.py::test_gram_nst_card_matches_cpu``
(ROADMAP Queue 3). The card's run parts from the f64 run at step 3, when a
near-zero gradient changes sign and Adam's normalized update moves its pixel
by ~lr; the CPU's f32 run meets the gate against the f64 run, so the gate
does not measure f32 arithmetic itself.
"""

import pytest
import torch

from neuralstyletransferv1_torch.experiments import gram_parting as gp

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this file, as the card test's CPU side
    runs (and so its summation order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cpu_f32_meets_the_card_tests_gate_against_f64():
    """The card test's CPU side, f32 on one thread, against f64: at the
    content image every stage agrees to f32's rounding (features, Grams,
    loss, gradient; no gradient sign flips); after ten steps within the card
    test's gate (mean |Δ| ≤ 1e-4, ≥ 99.9% of the pixels within 1e-3;
    measured: all within 6.2e-4, a few sign flips from step 8 on)."""
    ref = gp._run(CPU, torch.float64)
    c = gp._compare(gp._run(CPU, torch.float32), ref)
    assert max(c["feature_rel"].values()) < 1e-5 and max(c["gram_rel"].values()) < 1e-5
    assert c["loss_rel"] < 1e-6 and c["grad_rel"] < 1e-5 and c["grad_sign_flips"] == 0
    assert [s["step"] for s in c["steps"]] == list(range(1, gp.STEPS + 1))
    last = c["steps"][-1]
    assert last["img_mean_abs"] <= 1e-4 and last["share_within_gate"] >= 0.999, last


def test_diagnostic_prints_its_columns(capsys):
    """``main(["--device", "cpu"])``: the CPU f32 column against f64, a line
    a step and one JSON line."""
    import json

    assert gp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["reference"] == "cpu f64" and list(rec["columns"]) == ["cpu f32"]
    assert out[0].startswith("cpu f32 vs cpu f64:") and len(out) == gp.STEPS + 2
