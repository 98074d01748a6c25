"""The multi-node torchrun recipe (``scanpaths_tpu_torch/tools/
dist_smoke.py``) on the CPU: two ``torchrun --nnodes 2`` launches of two
gloo ranks each (a free port per test), each rank on ``cli/train.py``'s
path for two supervised steps, against one process on the same global
batches, at ``tests/test_torch_mesh.py``'s bounds (the first step's loss
at rtol 2e-5, every step's loss and gradient norm at 1e-3); and the
checks of the launch that the tool makes, each failing on a wrong
record."""

import copy

import numpy as np
import pytest

from scanpaths_tpu_torch.tools import dist_smoke


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    return dist_smoke.launch(str(tmp_path_factory.mktemp("dist")),
                             device="cpu")


def test_second_node_ranks_have_their_local_ranks(launched):
    assert [(r["rank"], r["local_rank"], r["node"], r["world"])
            for r in launched["ranks"]] == [
        (0, 0, 0, 4), (1, 1, 0, 4), (2, 0, 1, 4), (3, 1, 1, 4)]
    assert all(r["device"] == "cpu" and r["backend"] == "gloo"
               for r in launched["ranks"])


def test_losses_equal_one_process(launched):
    single = launched["single"]["losses"]
    assert len(single) == dist_smoke.STEPS and np.all(np.isfinite(single))
    for r in launched["ranks"]:
        np.testing.assert_allclose(r["losses"][0], single[0], rtol=2e-5)
        np.testing.assert_allclose(r["losses"], single, rtol=1e-3)
    assert max(launched["gap"]["losses"]) <= 1e-3


def test_grad_norms_equal_one_process(launched):
    """The global gradient norm before the clip, which a gradient not
    summed over the ranks would move (a loss two steps in hardly moves)."""
    single = launched["single"]["grad_norms"]
    assert len(single) == dist_smoke.STEPS and np.all(np.isfinite(single))
    for r in launched["ranks"]:
        np.testing.assert_allclose(r["grad_norms"], single, rtol=1e-3)
    assert max(launched["gap"]["grad_norms"]) <= 1e-3


@pytest.mark.parametrize("fault", ["local_rank", "device", "loss",
                                   "rank_loss", "unsummed_grads"])
def test_check_refuses_a_wrong_record(launched, fault):
    single = copy.deepcopy(launched["single"])
    ranks = copy.deepcopy(launched["ranks"])
    if fault == "local_rank":
        ranks[2]["local_rank"] = 2          # LOCAL_RANK taken as RANK
    elif fault == "device":
        ranks[3]["device"] = "cuda:3"
    elif fault == "loss":
        single["losses"][1] *= 1.01
    elif fault == "rank_loss":
        ranks[1]["losses"][0] += 1e-3
    else:
        # every rank's gradient a quarter of the global one: summed over
        # no rank, or averaged where it should be summed
        for r in ranks:
            r["grad_norms"] = [0.25 * g for g in r["grad_norms"]]
    with pytest.raises(AssertionError):
        dist_smoke.check(single, ranks, "cpu")
    dist_smoke.check(launched["single"], launched["ranks"], "cpu")
