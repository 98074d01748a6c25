"""The eval forward's prepared weights (scanpaths_tpu_torch/models/
prepared.py): made once a weight version, and made anew after each kind
of weight change, the forward then equal to a fresh model's on the new
weights; COCO's heads kept by a caller gathered with the same id check
as the model's own.  A tiny COCO model on the CPU at one torch thread
(it has every preparation: the stem, the stages with a stage stack and
a layer-4 block, the cell, the bank's composition)."""

import collections

import pytest
import torch

from scanpaths_tpu_torch.models import prepared
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel, \
    init_weights
from scanpaths_tpu_torch.ops import _build, cell

GEO = dict(embed=32, seq_len=2, map_h=5, map_w=6,
           backbone_layers=(2, 1, 1, 2))
# every preparation of the model once: the stem, each of the four
# stages, the cell, the composition
PREPARED = {"stem": 1, "stage": 4, "cell": 1, "composed": 1}


def _fresh(state=None):
    model = ScanpathModel("coco", **GEO)
    if state is None:
        init_weights(model, 0)
        with torch.no_grad():
            model.conditioner.bank_bias.normal_(
                0, 0.3, generator=torch.Generator().manual_seed(1))
    else:
        model.load_state_dict(state)
    return model.eval()


@pytest.fixture(scope="module")
def coco():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(2)
    inputs = (torch.randn((3, 40, 48, 3), generator=gen),
              torch.rand((3, GEO["map_h"], GEO["map_w"], 1), generator=gen),
              torch.tensor([4, 17, 4]))
    yield _fresh(), inputs
    torch.set_num_threads(threads)


@pytest.fixture
def builds(monkeypatch):
    """How many times each preparation was made (not read back)."""
    counts = collections.Counter()
    real = prepared.cached

    def spy(owner, name, sources, build):
        def counted():
            counts[name[0]] += 1
            return build()
        return real(owner, name, sources, counted)
    monkeypatch.setattr(prepared, "cached", spy)
    return counts


def _step(model, inputs):
    params = list(model.parameters())
    gen = torch.Generator().manual_seed(3)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    torch.optim.Adam(params, lr=1e-3).step()
    for p in params:
        p.grad = None


def _load_state_dict(model, inputs):
    state = {k: v * 1.01 if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    model.load_state_dict(state)


def _bn_stats(model, inputs):
    with torch.no_grad():
        model.forward_train(*inputs, train=True)


def _to_dtype(model, inputs):
    model.to(torch.float64).to(torch.float32)


# the change, and the preparations it must make anew (the others are
# read back)
CHANGES = {"step": (_step, PREPARED),
           "load_state_dict": (_load_state_dict, PREPARED),
           "bn_stats": (_bn_stats, {"stem": 1, "stage": 4}),
           "to_dtype": (_to_dtype, PREPARED)}


@pytest.mark.parametrize("change", list(CHANGES))
def test_prepared_weights_follow_the_weights(coco, builds, change):
    """After the change, two eval forwards equal a fresh model's eval
    forward on the new weights bit for bit, and between them each
    preparation the change touched was made exactly once more, the
    others not at all."""
    model, inputs = coco
    model(*inputs)                       # whatever came before, prepared
    builds.clear()
    apply, remade = CHANGES[change]
    apply(model, inputs)
    first, again = model(*inputs), model(*inputs)
    assert dict(builds) == remade
    want = _fresh(model.state_dict())(*inputs)
    for key in want:
        assert torch.equal(first[key], want[key]), key
        assert torch.equal(again[key], want[key]), key


@pytest.mark.parametrize("ids", [[0, 18, 2], [-1, 3, 2]],
                         ids=["past", "negative"])
def test_heads_kept_by_a_caller_refuse_ids_outside_the_bank(coco, ids):
    """The ``heads=`` path (a serving bundle's) checks host ids as the
    model's own composition does (``test_torch_compose.py::
    test_host_ids_outside_the_bank_raise``): ValueError, and in range it
    is the model's own forward."""
    model, (images, maps, good) = coco
    heads = prepared.heads(model)
    with pytest.raises(ValueError, match="outside the bank"):
        model(images, maps, torch.tensor(ids), heads=heads)
    got, want = model(images, maps, good, heads=heads), \
        model(images, maps, good)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_a_kernel_layout_is_kept_beside_its_weight_not_on_it():
    """``_build.packed`` keeps a layout in the one cache, nothing on the
    tensor, and lets it go with the tensor."""
    kh = torch.randn((3, 3, 32, 128))
    kt = _build.packed(kh, cell.pack_gate_kernel)
    assert _build.packed(kh, cell.pack_gate_kernel) is kt
    assert not [k for k in vars(kh) if "pack" in k]
    before = len(_build._CACHE)
    del kh
    assert len(_build._CACHE) == before - 1
