"""The multi-node torchrun recipe across real process boundaries (port of
``tools/dist_smoke.py``).

Two ``torchrun --nnodes 2 --node_rank {0,1} --nproc_per_node 2
--master_addr 127.0.0.1 --master_port <free>`` launches start at once:
four ranks, of which ranks 2 and 3, the second node's, have
``LOCAL_RANK`` 0 and 1.  Each rank runs ``cli/train.py``'s path
(``train/mesh.py::make_mesh``, the ``Trainer``, whose loaders load the
rank's slice of every global batch, ``steps.device_batch`` and
``steps.supervised_step``) for two supervised steps at the JAX tool's
tiny geometry (``--mesh_size 0``) at a global batch of 16: the JAX
tool's 8 does not divide, since the SCST loader that every ``Trainer``
builds takes a quarter of ``--batch`` a step, which must divide over the
four ranks.  A single process runs the same global batches meanwhile,
and the ranks' per-step losses and global gradient norms (before the
clip) must equal its own within :data:`RTOL`: the norms show a gradient
that was not summed over the ranks, which two steps' losses cannot
(Adam's first steps move each weight by about lr times the sign of its
gradient, so the second loss hardly depends on the gradient's size).  Each rank records its ``(RANK, LOCAL_RANK, device,
backend)``: a rank takes ``cuda:LOCAL_RANK % cards``, and ranks that
share a card talk over gloo, so on a one-card machine ranks 2 and 3
land on ``cuda:0``, where a tensor placed on ``cuda:RANK`` would raise.

The nodes share one filesystem: rank 0 writes the run's files and the
other ranks read rank 0's record after a barrier
(``train/trainer.py::RunFiles``), so a run over several machines needs a
shared filesystem for ``--log_root``.  This smoke runs both nodes on one
machine and claims no more.

    python -m scanpaths_tpu_torch.tools.dist_smoke [--device cuda|cpu]
        [--tmp DIR] [--steps 2]

prints one JSON line (every rank's record and the single process's
losses) and exits 0 when the checks hold.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
from os.path import exists, join

import numpy as np
import torch

STEPS = 2
GLOBAL_BATCH = 16
NODES, PER_NODE = 2, 2
TINY = ["--task", "osie", "--map_height", "5", "--map_width", "6",
        "--height", "40", "--width", "48", "--max_length", "4",
        "--backbone_layers", "1,1,1,1", "--embed", "64",
        "--batch", str(GLOBAL_BATCH), "--mesh_size", "0",
        "--epoch", "2", "--start_rl_epoch", "5"]
# (the first step, every step): the ranks' losses and gradient norms
# against the single process's, relative.  On the CPU
# tests/test_torch_mesh.py's bounds: the first loss at the JAX mesh's
# 2e-5, a run's training scalars at 1e-3 (the norms part by 1.8e-4: the
# two sides' BN formulas and batch splits part the float32 gradients in
# the last bits).  On the card this drive's own readings set them: the
# losses parted by 8.8e-6 and 1.4e-5.  A gradient left unsummed over the
# ranks parts the norms by 0.26 (a CPU run with the all-reduce taken out)
RTOL = {"cpu": {"losses": (2e-5, 1e-3), "grad_norms": (1e-3, 1e-3)},
        "cuda": {"losses": (1e-4, 1e-3), "grad_norms": (1e-2, 1e-2)}}
TIMEOUT = 900     # s, all the processes together
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker(out_path: str, data_root: str, log_root: str, steps_n: int,
           device: str) -> dict:
    """One rank (under torchrun) or the single process: ``cli/train.py``'s
    mesh and ``Trainer`` on the tiny flags, ``steps_n`` supervised steps;
    writes its record to ``out_path``."""
    # scalars.jsonl alone: the smoke reads no TensorBoard file, and
    # importing TensorBoard (it pulls in TensorFlow) costs a process
    # seconds
    sys.modules.setdefault("torch.utils.tensorboard", None)
    from ..core.config import parse_opt
    from ..train import mesh, steps
    from ..train.trainer import Trainer

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    args = parse_opt(TINY + [
        "--img_dir", join(data_root, "osie", "stimuli"),
        "--fix_dir", join(data_root, "osie", "fixations"),
        "--log_root", log_root])
    m = mesh.make_mesh(args, torch.device(device))
    np.random.seed(args.seed)
    trainer = Trainer(args, m.device)
    losses, norms = [], []
    for i, batch in enumerate(trainer.train_loader):
        if i >= steps_n:
            break
        db = steps.device_batch(batch, m.device, for_rl=False)
        out = steps.supervised_step(trainer.state, db, args.lambda_1)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    env = os.environ
    rec = {"rank": m.rank, "world": m.world,
           "local_rank": int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env
           else None,
           "node": int(env["GROUP_RANK"]) if "GROUP_RANK" in env else None,
           "device": str(m.device), "backend": m.backend, "losses": losses,
           "grad_norms": norms}
    trainer.close_run()
    mesh.close_mesh(m)
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return rec


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_cmd(out_path, data_root, log_root, steps_n, device):
    return ["-m", "scanpaths_tpu_torch.tools.dist_smoke", "--worker",
            out_path, "--data", data_root, "--log_root", log_root,
            "--steps", str(steps_n), "--device", device]


def _wait(procs: dict, timeout: float) -> None:
    """Waits for every process (name -> (Popen, log path)), each in a
    process group of its own; on a timeout or a failure kills them all and
    raises with the failing one's log tail."""
    import time
    deadline = time.monotonic() + timeout
    failed = None
    try:
        for name, (p, log) in procs.items():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
            if p.returncode and failed is None:
                failed = name
    except subprocess.TimeoutExpired:
        failed = f"timeout after {timeout} s (first: {name})"
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if failed is not None:
        name = failed if failed in procs else next(iter(procs))
        with open(procs[name][1]) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"dist_smoke: {failed} failed:\n{tail}")


def launch(tmp: str, device: str = "cuda", steps_n: int = STEPS,
           timeout: float = TIMEOUT) -> dict:
    """The single process and the two nodes' launches, started together
    under ``tmp``; returns {"single": its record, "ranks": [records by
    rank], "gap": {"losses": the relative gap a step, "grad_norms": the
    same}}, after the checks."""
    from . import synth
    os.makedirs(tmp, exist_ok=True)
    data_root = join(tmp, "data")
    if not exists(join(data_root, "osie")):
        # steps_n x GLOBAL_BATCH supervised train records (4 subjects an
        # image)
        synth.make_osie(join(data_root, "osie"), np.random.default_rng(0),
                        n_images=max(steps_n * GLOBAL_BATCH // 4, 1),
                        n_subjects=4)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    port = free_port()
    out = join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    cmds = {"single": [sys.executable, *_worker_cmd(
        join(out, "single.json"), data_root, join(tmp, "log_single"),
        steps_n, device)]}
    for node in range(NODES):
        cmds[f"node{node}"] = [
            sys.executable, "-m", "torch.distributed.run",
            f"--nnodes={NODES}", f"--node_rank={node}",
            f"--nproc_per_node={PER_NODE}", "--master_addr=127.0.0.1",
            f"--master_port={port}", *_worker_cmd(
                join(out, "rank{rank}.json"), data_root,
                join(tmp, "log_nodes"), steps_n, device)]
    procs = {}
    for name, cmd in cmds.items():
        log = join(tmp, f"{name}.log")
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                start_new_session=True), log)
    _wait(procs, timeout)

    with open(join(out, "single.json")) as f:
        single = json.load(f)
    world = NODES * PER_NODE
    ranks = []
    for r in range(world):
        with open(join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"single": single, "ranks": ranks,
            "gap": check(single, ranks, device)}


def check(single: dict, ranks: list, device: str) -> list:
    """The ranks against the launch and the single process: RANK = node x
    PER_NODE + LOCAL_RANK, each on ``cuda:LOCAL_RANK % cards`` (gloo where
    ranks share a card) or the CPU, every rank's losses and gradient norms
    equal (they are global), and within :data:`RTOL` of the single
    process's.  Returns {"losses": the relative gap of each step,
    "grad_norms": the same}."""
    kind = torch.device(device).type
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    for r, rec in enumerate(ranks):
        want_local, want_node = r % PER_NODE, r // PER_NODE
        if (rec["rank"], rec["local_rank"], rec["node"], rec["world"]) != \
                (r, want_local, want_node, NODES * PER_NODE):
            raise AssertionError(f"rank {r}: {rec}")
        want_dev = f"cuda:{want_local % cards}" if kind == "cuda" else "cpu"
        shared = kind != "cuda" or PER_NODE > cards
        if rec["device"] != want_dev or \
                rec["backend"] != ("gloo" if shared else "nccl"):
            raise AssertionError(f"rank {r} on {rec['device']} over "
                                 f"{rec['backend']}, expected {want_dev}")
    gaps = {}
    for key, (first, every) in RTOL[kind].items():
        for r, rec in enumerate(ranks):
            if rec[key] != ranks[0][key]:
                raise AssertionError(f"rank {r}'s {key} {rec[key]} against "
                                     f"rank 0's {ranks[0][key]}")
        got = np.asarray(ranks[0][key])
        want = np.asarray(single[key])
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{key} {got} against {want}")
        gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-12)
        if not (gap[0] <= first and np.all(gap <= every)):
            raise AssertionError(f"{key} over ranks {got} against one "
                                 f"process's {want}: gaps {gap}, bounds "
                                 f"{first} (first step), {every}")
        gaps[key] = gap.tolist()
    return gaps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--tmp", default="",
                   help="working directory (default: a new temporary one)")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--worker", default="", help=argparse.SUPPRESS)
    p.add_argument("--data", default="", help=argparse.SUPPRESS)
    p.add_argument("--log_root", default="", help=argparse.SUPPRESS)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    if a.worker:
        out = a.worker.format(rank=os.environ.get("RANK", 0))
        return worker(out, a.data, a.log_root, a.steps, a.device)
    r = launch(a.tmp or tempfile.mkdtemp(prefix="sp_dist_smoke_"), a.device,
               a.steps)
    print(json.dumps(r), flush=True)
    print(f"dist_smoke ok: {NODES} nodes x {PER_NODE} ranks, ranks' "
          f"(RANK, LOCAL_RANK, device): "
          + ", ".join(f"({x['rank']}, {x['local_rank']}, {x['device']})"
                      for x in r["ranks"])
          + f"; losses and gradient norms equal one process's to "
            f"{max(r['gap']['losses']):.2e} and "
            f"{max(r['gap']['grad_norms']):.2e} relative", flush=True)
    return r


if __name__ == "__main__":
    main()
