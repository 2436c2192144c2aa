"""A run with the timed path broken underneath: the harness's look for a
card skipped, a small configuration on the CPU, the rest of a run as it
is, and `correct` must come out false."""

import pytest
import torch

from gwtf_bench import faults, run

SPEC = run.Spec()
TINY = dict(n_components=2, p_decoder_n_flows=2, p_decoder_n_features=8,
            g_latent_space_size=16, g_prior_n_flows=2, g_prior_n_features=8,
            pc_enc_init_n_features=8, pc_enc_n_features=[8, 16, 16],
            batch_size=6, cloud_size=64, image_size=[32, 32])
CELLS = [w["name"] for w in SPEC.raw["workloads"]]


def _run(cell, hooks, seed=2200000000077):
    cfg = SPEC.config(SPEC.cell(cell))
    cfg.update(TINY)
    return run.run_cell(SPEC, cell, seed, 0.5, False, device="cpu",
                        hooks=hooks, config=cfg)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch],
                         ids=["unchanged", "half_batch"])
def test_a_fault_is_not_correct(cell, fault):
    sound = _run(cell, {})
    out = _run(cell, {"step": fault})
    assert out["correct"] is False
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "build_s", "checks"]
    # the fault reads above the sound run in some number it is over
    # the limit in
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over
    assert all(out["checks"][k]["value"] > sound["checks"][k]["value"]
               for k in over)


def test_the_unchanged_state_reads_one():
    """Every moved leaf's change reads 1 but those under the median's,
    which read their share of it; the worst gradient reads 1."""
    out = _run(CELLS[0], {"step": faults.unchanged})
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert 0.9 < out["checks"]["change_gap"]["value"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell):
    """The reference in TF32 in the program's place, at the cell's size,
    fails a limit that the program meets (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control is TF32)")
    from gwtf_bench import calibrate

    out = calibrate.readings(SPEC, cell, 2200000000101, True, False)
    limits = SPEC.limits(SPEC.cell(cell))
    assert all(out["program"][k] <= limits[k] for k in limits)
    assert any(out["control_tf32"][k] > limits[k] for k in limits)
