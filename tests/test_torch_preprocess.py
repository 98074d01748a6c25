"""The port's copies of the offline preprocessing
(scanpaths_tpu_torch/data/preprocess.py, cli/preprocess.py):
tests/test_preprocess.py's three tests run against them, on the same
seeded raw inputs as against the JAX package's, and every split file the
two write is the same byte for byte."""

import pytest
import test_preprocess as tp

from scanpaths_tpu.cli import preprocess as jax_cli
from scanpaths_tpu.data import preprocess as jax_pre
from scanpaths_tpu_torch.cli import preprocess as port_cli
from scanpaths_tpu_torch.data import preprocess as port_pre


@pytest.mark.parametrize("case", ["osie", "air", "cli"])
def test_port_preprocess_mirrors_the_jax_package(case, tmp_path,
                                                 monkeypatch):
    written = {}
    for name, pre, cli in (("jax", jax_pre, jax_cli.main),
                           ("port", port_pre, port_cli.main)):
        monkeypatch.setattr(tp, "preprocess_osie", pre.preprocess_osie)
        monkeypatch.setattr(tp, "preprocess_air", pre.preprocess_air)
        # test_preprocess_cli imports main from the JAX package's module
        monkeypatch.setattr(jax_cli, "main", cli)
        root = tmp_path / name
        root.mkdir()
        getattr(tp, f"test_preprocess_{case}")(root)
        written[name] = {p.relative_to(root): p.read_bytes()
                         for p in sorted(root.rglob("*.json"))}
    assert written["port"] and written["port"] == written["jax"]
