"""The comparison that decides ``correct``, and the faults it has to catch,
driven through whole rehearsal runs with the timed path broken underneath."""

import math

import pytest

from benchlib import check, driver


def _ro(loss, dn, mom, chg):
    return check.readout(loss, dn, mom, chg)


LIMITS = {k: 0.01 for k in check.NUMBERS}


def test_gaps_by_the_worst_leaf_against_the_median():
    ref = _ro([2.0, 1.0], [1.0, 1.0], {"a": 1.0, "b": 2.0, "c": 4.0, "z": 1e-9},
              {"a": 1.0, "b": 2.0, "c": 4.0, "z": 1e-9})
    prog = _ro([2.0, 1.001], [1.0, 1.0], {"a": 1.01, "b": 2.0, "c": 4.0, "z": 5.0},
               {"a": 1.0, "b": 2.0, "c": 4.2, "z": 0.0})
    numbers, correct, left_out = check.compare(prog, ref, LIMITS)
    assert left_out == ["z"]  # under a thousandth of the median: round-off
    assert numbers["loss_gap"]["value"] == pytest.approx(1e-3)
    assert numbers["momentum_gap"]["value"] == pytest.approx(0.01 / 2.0)  # the median's base
    assert numbers["change_gap"]["value"] == pytest.approx(0.05)
    assert not correct


def test_non_finite_fails():
    ref = _ro([1.0], [1.0], {"a": 1.0}, {"a": 1.0})
    prog = _ro([math.nan], [1.0], {"a": 1.0}, {"a": 1.0})
    numbers, correct, _ = check.compare(prog, ref, LIMITS)
    assert math.isinf(numbers["loss_gap"]["value"]) and not correct


@pytest.mark.parametrize("workload", ["resnet20.fig2b.k4", "olmo1b.seq64.k2"])
def test_sound_rehearsal_agrees_with_the_reference(registry, workload):
    """The port against the plain reference at smoke widths on the CPU, one
    chunk: f32 on both sides, so the gaps are round-off."""
    out = driver.run_cell(registry, workload, seed=2**31 + 77, seconds=0.0, trace=False,
                          t_start=0.0, rehearse=True)
    assert out["correct"]
    assert all(v["value"] < 1e-3 for v in out["checks"].values()), out["checks"]
    assert out["device"]["platform"] == "cpu" and out["metrics"] == {}


def _state_unchanged(monkeypatch):
    from repro_torch.fl.trainer import FLTrainer

    monkeypatch.setattr(FLTrainer, "_take_carry", lambda self, carry: None)


def _half_batch(monkeypatch, registry, workload):
    fam = registry.module("families", registry.data("configs", registry.cell(workload)["config"])["family"])
    real = fam.program

    def program(config, device):
        loss_fn, tree_of = real(config, device)

        def half(params, batch):
            return loss_fn(params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

        return half, tree_of

    monkeypatch.setattr(fam, "program", program)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", ["resnet20.fig2b.k4", "olmo1b.seq64.k2"])
def test_faults_come_out_incorrect(registry, monkeypatch, workload, fault):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch)
    else:
        _half_batch(monkeypatch, registry, workload)
    out = driver.run_cell(registry, workload, seed=2**31 + 5, seconds=0.0, trace=False,
                          t_start=0.0, rehearse=True)
    assert not out["correct"], out["checks"]
