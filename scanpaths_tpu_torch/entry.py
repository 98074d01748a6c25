"""The port's entry points (port of ``__graft_entry__.py``).

``entry()``              the flagship OSIE eval forward at full geometry
                         (240x320 images, a 30x40 action grid, T = 16,
                         batch 8): ``(fn, example_args)`` with
                         ``fn(state, images)``, the weights an argument
                         as JAX's ``variables`` are.
``dryrun_multichip(n)``  one real data-parallel supervised step and one
                         SCST step (its ScanMatch reward on the NW
                         kernel) over ``n`` ranks, for even n >= 4 the
                         (n/2) x 2 row-parallel steps too, and the
                         world-n step time against world 1's, at a tiny
                         geometry.  The command to run before a
                         multi-card job:

    python -m scanpaths_tpu_torch.entry [n] [--device cuda|cpu]

(n = 8 by default, as ``python __graft_entry__.py``).
``dryrun_multichip`` runs its body in a fresh ``torchrun --standalone
--nproc_per_node n`` child (torchrun picks a free port), a process a
rank, as the trainers run over ranks (``train/mesh.py``): ranks that
share a card, or run on the CPU, talk over gloo, so n may exceed the
cards.  The world-1 step it compares with runs on rank 0 once the
process group is closed, where the mesh helpers are the identity.  Both
run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import torch

# the flagship geometry (reference OSIE/opts.py; ResNet-50 and embed 512)
FULL = dict(batch=8, height=240, width=320, map_h=30, map_w=40, seq_len=16,
            embed=512, backbone_layers=(3, 4, 6, 3))
# the dry run's: one bottleneck a stage at embed 128 keeps each rank's
# steps to seconds on a few CPU cores, with the full model's structure
DRY = dict(map_h=10, map_w=12, seq_len=4, embed=128,
           backbone_layers=(1, 1, 1, 1))
TP_RTOL = 1e-4        # the row-parallel loss against the replicated one
TIMEOUT = 1800        # s, the torchrun child
TIME_ITERS = 3        # supervised steps a side of the world-n/world-1 line


def entry(device="cuda", batch=FULL["batch"], height=FULL["height"],
          width=FULL["width"], map_h=FULL["map_h"], map_w=FULL["map_w"],
          seq_len=FULL["seq_len"], embed=FULL["embed"],
          backbone_layers=FULL["backbone_layers"], seed=0):
    """Returns ``(fn, (state, images))``: ``fn(state, images)`` is the eval
    forward (``ScanpathModel.forward``: the stage and cell kernels on the
    card) of ``cli/train.py``'s OSIE model (``model_from_flags``) at this
    geometry, run by ``torch.func.functional_call`` with ``state`` as its
    parameters and buffers; ``state`` holds ``init_weights(model, seed)``
    on ``device`` and ``images`` is float32 zeros [batch, height, width,
    3].  The module keeps no weights of its own (they are on the meta
    device), so ``state`` is the forward's only source of weights."""
    from .core.config import parse_opt
    from .models.scanpath_model import init_weights, model_from_flags
    args = parse_opt([
        "--task", "osie", "--height", str(height), "--width", str(width),
        "--map_height", str(map_h), "--map_width", str(map_w),
        "--max_length", str(seq_len), "--embed", str(embed),
        "--backbone_layers", ",".join(str(v) for v in backbone_layers)])
    model = model_from_flags(args)
    init_weights(model, seed)
    state = {k: v.to(device) for k, v in model.state_dict().items()}
    model.to("meta").eval()
    images = torch.zeros((batch, height, width, 3), dtype=torch.float32,
                         device=device)

    def fn(state, images):
        return torch.func.functional_call(model, state, (images,),
                                          strict=True)

    return fn, (state, images)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = TIMEOUT) -> str:
    """Runs :func:`_dryrun_body` over ``n_devices`` ranks in a fresh
    ``torchrun --standalone`` child, in a process group of its own that
    is killed whole on the timeout; echoes its output and returns its
    standard output.  Raises unless every rank exits 0."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n_devices}", "-m", "scanpaths_tpu_torch.entry",
           str(n_devices), "--device", str(device), "--dryrun-body"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=root, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"dryrun_multichip: the torchrun child passed "
                           f"{timeout} s:\n{err[-3000:]}") from None
    sys.stdout.write(out)
    sys.stderr.write(err)
    sys.stdout.flush()
    sys.stderr.flush()
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun_multichip: the torchrun child failed "
                           f"(rc={proc.returncode}); output above")
    return out


def _dry_args():
    """The optimizer and schedule flags of the dry run's steps."""
    return types.SimpleNamespace(
        lr=1e-4, clip=12.5, weight_decay=5e-4, warmup_epoch=1,
        start_rl_epoch=5, epoch=10, rl_lr_initial_decay=0.5,
        bf16_moments=False)


def _dry_model():
    """The dry run's thin OSIE model, from seed 0."""
    from .models.scanpath_model import ScanpathModel, init_weights
    net = ScanpathModel("osie", embed=DRY["embed"], seq_len=DRY["seq_len"],
                        map_h=DRY["map_h"], map_w=DRY["map_w"],
                        backbone_layers=DRY["backbone_layers"])
    init_weights(net, 0)
    return net


def _dry_batch(n: int, device) -> dict:
    """The dry run's supervised global batch of ``n`` images, seed 0."""
    mh, mw, t = DRY["map_h"], DRY["map_w"], DRY["seq_len"]
    rng = np.random.default_rng(0)
    scan = np.zeros((n, t, mh * mw + 1), np.float32)
    scan[:, :, 1] = 1.0
    arrays = {"images": rng.normal(size=(n, 8 * mh, 8 * mw, 3))
              .astype(np.float32),
              "scanpaths": scan,
              "durations": np.full((n, t), 0.3, np.float32),
              "action_masks": np.ones((n, t), np.float32),
              "duration_masks": np.ones((n, t), np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def _step_seconds(state, batch, iters: int = TIME_ITERS) -> float:
    """Seconds a supervised step of ``state`` on ``batch`` takes, the mean
    of ``iters`` steps, each read on the host."""
    from .train import steps
    device = batch["images"].device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        float(steps.supervised_step(state, batch, 1.0)["loss"])
    return (time.perf_counter() - t0) / iters


def _dryrun_body(n_devices: int, device: str) -> None:
    """One rank of the dry run, under torchrun: on the mesh of the launch
    (``train/mesh.py::make_mesh``), from the seed weights of a thin OSIE
    model and one global batch of ``n_devices`` images (one a rank):

    * a data-parallel supervised step and an SCST step (2 rollouts, the
      ScanMatch reward on the NW kernel) over the ranks;
    * for even n >= 4, the same steps on the (n/2) x 2 row-parallel mesh
      (``train/tp_step.py``: the h- and x-gate kernels sliced over the
      model group) from the same weights; the supervised loss must equal
      the replicated step's within ``TP_RTOL``;
    * the supervised step at world n (n images) against world 1 (one
      image), each the mean of TIME_ITERS steps read on the host: world
      1 on rank 0 once the process group is closed, where the mesh
      helpers are the identity (ranks that share a card or the CPU: a
      shape report, not a scaling number).

    Rank 0 prints a line a step and the kernel launches of all ranks."""
    from .core.grid import GridSpec
    from .train import mesh, steps, tp_step
    from .utils import tracing

    m = mesh.make_mesh(argparse.Namespace(mesh_size=0, model_parallel=1),
                       device)
    if m.world != n_devices:
        raise RuntimeError(f"dry run of {n_devices} ranks launched "
                           f"{m.world}")
    say = print if m.is_primary else (lambda *a, **k: None)
    mh, mw, t = DRY["map_h"], DRY["map_w"], DRY["seq_len"]
    h, w = 8 * mh, 8 * mw
    n = n_devices
    args, model = _dry_args(), _dry_model

    def put(arrays):
        return {k: torch.as_tensor(v, device=m.device)
                for k, v in arrays.items()}

    def rows(batch):
        """This data rank's rows of a global batch."""
        return {k: mesh.slice_rows(v, 0) for k, v in batch.items()}

    batch = _dry_batch(n, m.device)
    rng = np.random.default_rng(1)
    smax, glen = 4, 8
    gt_fix = np.zeros((n, smax, glen, 3), np.float32)
    gt_fix[..., 0] = rng.uniform(0, w, (n, smax, glen))
    gt_fix[..., 1] = rng.uniform(0, h, (n, smax, glen))
    gt_fix[..., 2] = rng.uniform(0.1, 0.5, (n, smax, glen))
    rl_batch = {"images": batch["images"], **put({
        "gt_fix": gt_fix, "gt_len": np.full((n, smax), glen, np.int32),
        "gt_mask": np.ones((n, smax), np.float32)})}
    grid = GridSpec(map_width=mw, map_height=mh, width=w, height=h,
                    max_length=t, min_length=1)
    cfg = steps.RLConfig(task="osie", grid=grid, rl_sample_number=2,
                         max_symbols_wd=32)

    def generator(seed):
        return torch.Generator(device=m.device).manual_seed(seed)

    # ---- data parallel over the n ranks ----
    state = steps.TrainState.create(model(), args, 10, 10, device=m.device)
    loss = float(steps.supervised_step(state, rows(batch), 1.0)["loss"])
    say(f"dryrun supervised step ok on {n} ranks ({m.describe()}): "
        f"loss={loss:.4f}", flush=True)
    rl = steps.rl_step(state, rows(rl_batch), cfg, generator=generator(1))
    say(f"dryrun rl step ok on {n} ranks: "
        f"reward={float(rl['reward_hmean']):.4f}", flush=True)

    # ---- row-parallel tensor parallelism: (n/2 data) x (2 model) ----
    if n >= 4 and n % 2 == 0:
        mesh.set_model_parallel(2)
        state_tp = tp_step.TPTrainState.create(model(), args, 10, 10,
                                               device=m.device)
        loss_tp = float(steps.supervised_step(state_tp, rows(batch),
                                              1.0)["loss"])
        kern = state_tp.model.lstm.gates_h.weight
        if not (tp_step.is_sliced(kern)
                and kern.shape[1] == DRY["embed"] // 2):
            raise AssertionError(f"gate kernel not sliced: "
                                 f"{tuple(kern.shape)}")
        gap = abs(loss_tp - loss)
        if gap > TP_RTOL * max(abs(loss), 1.0):
            raise AssertionError(f"row-parallel loss {loss_tp} against the "
                                 f"replicated step's {loss}")
        say(f"dryrun row-parallel supervised step ok on {n // 2}x2 (data x "
            f"model) mesh: loss={loss_tp:.4f} equals the replicated step's "
            f"to {gap:.1e} (bound {TP_RTOL:g} relative), gate kernel "
            f"stored sliced {DRY['embed']}->{kern.shape[1]} input channels "
            f"per rank", flush=True)
        rl_tp = steps.rl_step(state_tp, rows(rl_batch), cfg,
                              generator=generator(2))
        say(f"dryrun row-parallel rl step ok: "
            f"reward={float(rl_tp['reward_hmean']):.4f}, "
            f"rollout_ok_frac={float(rl_tp['rollout_ok_frac']):.2f}",
            flush=True)
        mesh.set_model_parallel(1)
        del state_tp

    # ---- the step's time at world n (n images) ----
    tn = _step_seconds(state, rows(batch))

    counts = tracing.launches()
    got = mesh.gather_to_primary([(m.rank, counts)])
    if m.is_primary:
        total = {k: sum(c[k] for _, c in got) for k in counts}
        say(f"dryrun kernel launches over the {n} ranks: "
            f"{json.dumps(total)}", flush=True)
    mesh.close_mesh(m)

    # ---- world 1 (one image), on rank 0 outside the process group ----
    if m.is_primary:
        if mesh.active():
            raise RuntimeError("the world-1 step runs outside any process "
                               "group")
        del state
        state = steps.TrainState.create(model(), args, 10, 10,
                                        device=m.device)
        one = _dry_batch(1, m.device)
        _step_seconds(state, one, iters=1)
        t1 = _step_seconds(state, one)
        say(f"dryrun scaling: supervised step {n} ranks ({n} images) "
            f"{tn * 1e3:.1f} ms vs 1 rank (1 image) {t1 * 1e3:.1f} ms; "
            f"wall ratio {tn / t1:.2f} (1.0 = ideal on cards of their own; "
            f"ranks sharing a card or the CPU serialize, so > 1 is "
            f"expected there)", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks of the dry run (default 8)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--dryrun-body", action="store_true",
                   help=argparse.SUPPRESS)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    if a.dryrun_body:
        _dryrun_body(a.n, a.device)
    else:
        dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
