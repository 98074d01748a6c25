"""The port's committed convergence artifact (CONVERGENCE_TORCH.json,
made on an H100 by ``python -m scanpaths_tpu_torch.tools.convergence_run``)
must show the two-phase optimization optimizing, as
``tests/test_convergence.py`` holds the JAX package's: the supervised
loss falling by 20%, the validation selection scalar rising over its
first value, the SCST phase holding its reward and its validation scalar
(a sign-flipped advantage collapses both), and SCST lifting the
validation scalar above the ``_supervised_save`` snapshot on the
headroom corpus (``tools/synth.py::make_osie_headroom``)."""

import json
import pathlib

import pytest

ART = pathlib.Path(__file__).parent.parent / "CONVERGENCE_TORCH.json"


@pytest.fixture(scope="module")
def art():
    return json.loads(ART.read_text())


def test_made_on_the_card(art):
    assert art["config"]["device"].startswith("NVIDIA H100")
    assert art["config"]["epochs_run"] == 12
    assert art["config"]["start_rl_epoch"] == 6


def test_supervised_loss_decreases(art):
    sup = art["supervised"]
    assert sup["loss_last_epoch_mean"] < 0.8 * sup["loss_first_epoch_mean"]
    assert art["deltas"]["supervised_loss_decreased"] is True


def test_validation_metric_improves_over_training(art):
    sup_val = art["supervised"]["val_metric_per_epoch"]
    best = max(sup_val + art["rl"]["val_metric_per_epoch"])
    assert best > sup_val[0], (best, sup_val)
    assert art["deltas"]["val_metric_improved_over_training"] is True


def test_rl_phase_does_not_collapse(art):
    rl = art["rl"]
    assert rl["reward_last_epoch_mean"] >= \
        0.9 * rl["reward_first_epoch_mean"], rl
    assert art["deltas"]["rl_reward_held"] is True
    assert rl["val_metric_per_epoch"][-1] >= \
        0.8 * rl["supervised_save_val_metric"], rl
    assert art["deltas"]["rl_val_held"] is True


def test_rl_improves_over_supervised_save(art):
    rl = art["rl"]
    assert rl["best_val_metric"] > rl["supervised_save_val_metric"], rl
    assert art["deltas"]["rl_improved_over_supervised_save"] is True
