"""The port's serving CLI (scanpaths_tpu_torch/cli/predict.py) on the
CPU: the JAX CLI's record schema, tail-chunk padding, the same greedy
scanpaths as the JAX CLI from the same weights, and the device and
checkpoint checks."""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from scanpaths_tpu.cli import predict as jax_predict
from scanpaths_tpu.core.config import parse_opt
from scanpaths_tpu.train.trainer import build_model
from scanpaths_tpu.utils.checkpointing import save_pytree
from scanpaths_tpu_torch.cli import predict
from scanpaths_tpu_torch.models import port

TINY = ["--task", "osie", "--map_height", "10", "--map_width", "10",
        "--height", "80", "--width", "80", "--max_length", "4",
        "--backbone_layers", "2,1,1,1", "--embed", "16", "--batch", "2"]
KEYS = {"name", "repeat_id", "X", "Y", "T", "length"}


def _flags(task):
    return ["--task", task] + TINY[2:]


def _images(tmp_path, n=3):
    rng = np.random.default_rng(0)
    d = tmp_path / "images"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (60, 90, 3), dtype=np.uint8)) \
            .save(d / f"img_{i}.png")
    return str(d)


def _run_dirs(tmp_path, task="osie"):
    """One set of weights, saved as the JAX CLI reads them (flax
    msgpack) and as the port reads them (reference-layout torch)."""
    args = parse_opt(_flags(task))
    model = build_model(args)
    kw = {}
    if task != "osie":
        kw["attention_maps"] = np.zeros((1, 10, 10, 1), np.float32)
    if task == "coco":
        kw["task_ids"] = np.zeros((1,), np.int32)
    vs = model.init(jax.random.PRNGKey(0),
                    np.zeros((1, 80, 80, 3), np.float32), train=False, **kw)
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "hparams.json").write_text(json.dumps({"task": task}))
    save_pytree(str(run / "checkpoints" / "checkpoint_best.msgpack"),
                {"model": {"params": vs["params"],
                           "batch_stats": vs["batch_stats"]}})
    tree = jax.tree.map(np.array, vs)
    sd = port._flax_to_reference(tree["params"], tree["batch_stats"], task,
                                 10, 10)
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}},
               run / "checkpoints" / "checkpoint_best.pth")
    return str(run)


def test_greedy_matches_the_jax_cli(tmp_path):
    _check_greedy_against_the_jax_cli(tmp_path, "osie")


@pytest.mark.parametrize("task", ["air", "coco"])
def test_greedy_matches_the_jax_cli_for_air_and_coco(tmp_path, task):
    """AiR from seeded attention maps (served by its good stream), COCO
    with a target category per image, so two bank heads share a
    batch."""
    _check_greedy_against_the_jax_cli(tmp_path, task)


def _check_greedy_against_the_jax_cli(tmp_path, task):
    """The same greedy scanpaths as the JAX CLI from the same weights."""
    imgs = _images(tmp_path)
    run = _run_dirs(tmp_path, task)
    common = _flags(task) + ["--predict_images", imgs, "--evaluation_dir",
                             run]
    if task == "air":
        rng = np.random.default_rng(1)
        maps = []
        for i in range(3):
            maps.append(str(tmp_path / f"att_{i}.npy"))
            np.save(maps[-1], rng.uniform(0, 1, (15, 20)).astype(np.float32))
        common += ["--predict_att", ",".join(maps)]
    elif task == "coco":
        common += ["--target_category", "cup,tv,cup"]
    want = jax_predict.main(common + ["--predict_out",
                                      str(tmp_path / "jax.json")])
    got = predict.main(common + ["--device", "cpu", "--predict_out",
                                 str(tmp_path / "torch.json")])
    assert json.loads((tmp_path / "torch.json").read_text()) == got
    assert len(got) == len(want) == 3          # 2 + a padded tail of 1
    for g, w in zip(got, want):
        assert set(g) == set(w) == KEYS
        assert (g["name"], g["repeat_id"], g["length"]) == \
            (w["name"], w["repeat_id"], w["length"])
        assert g["X"] == w["X"] and g["Y"] == w["Y"]
        np.testing.assert_allclose(g["T"], w["T"], rtol=1e-4)


def test_sampling_from_seed_weights(tmp_path, capsys):
    imgs = _images(tmp_path)
    argv = TINY + ["--predict_images", imgs, "--device", "cpu",
                   "--decode", "sample", "--num_samples", "3", "--seed", "4"]
    recs = predict.main(argv)
    assert "weights made from seed 4" in capsys.readouterr().err
    assert len(recs) == 9
    assert [r["repeat_id"] for r in recs[:3]] == [1, 1, 2]
    for r in recs:
        assert set(r) == KEYS
        assert 0 <= r["length"] <= 4
        assert len(r["X"]) == len(r["Y"]) == len(r["T"]) == r["length"]
        assert all(0 <= x <= 80 for x in r["X"] + r["Y"])
    assert predict.main(argv) == recs          # seeded: reproducible


def test_device_and_checkpoint_checks(tmp_path):
    imgs = _images(tmp_path, 1)
    argv = TINY + ["--predict_images", imgs]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            predict.main(argv)                 # --device defaults to cuda
    with pytest.raises(FileNotFoundError, match="checkpoint_best.pth"):
        predict.main(argv + ["--device", "cpu", "--evaluation_dir",
                             str(tmp_path)])
    with pytest.raises(ValueError, match="joint checkpoint one task at a"):
        predict.main(["--task", "joint", "--device", "cpu",
                      "--predict_images", imgs])
    with pytest.raises(ValueError, match="--target_category is required"):
        predict.main(["--task", "coco", "--device", "cpu",
                      "--predict_images", imgs])


def test_ablated_attention_serves_as_no_maps(tmp_path):
    """--ablate_attention_info zeroes the AiR attention maps: the same
    scanpaths as serving without --predict_att."""
    imgs = _images(tmp_path, 2)
    att = str(tmp_path / "att.npy")
    np.save(att, np.random.default_rng(2).uniform(0, 1, (15, 20)).astype(
        np.float32))
    argv = _flags("air") + ["--predict_images", imgs, "--device", "cpu",
                            "--seed", "5"]
    want = predict.main(argv)
    got = predict.main(argv + ["--predict_att", f"{att},{att}",
                               "--ablate_attention_info", "true"])
    assert got == want
    assert predict.main(argv + ["--predict_att", f"{att},{att}"]) != want
