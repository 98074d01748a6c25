"""What every driver of the benchmark shares: the cell's files, the card,
the program built from the seed's weights, the inputs, the spans around
the program's layers, the profiled slice, the output check and the
result line.

A driver (``drivers/<name>.py``) has one function, ``run(ctx)``, which
sets up, warms up, measures for ``ctx.seconds`` and checks, and returns
a :class:`Outcome`.  Everything a driver needs to know of its cell comes
from the files that ``BENCHMARK.json`` names: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``)
and the cell (``workloads/<cell>.json``: the output check's size and
limits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import random
import subprocess
import sys
import time

import torch

from .reference import compare, control, model as ref_model, sampler, weights

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in a run: JAX and the JAX
# package (compared whole, since the port's name starts with the
# latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "scanpaths_tpu")
# exit codes
NO_CARD, NO_RESULT = 2, 3


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` and the files it names."""
    name: str
    entry: dict
    cfg: dict
    mix: dict
    spec: dict
    bench: dict

    @classmethod
    def find(cls, name: str, bench_path: pathlib.Path = ROOT /
             "BENCHMARK.json") -> "Cell":
        bench = load_json(bench_path)
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            raise SystemExit(f"no workload {name!r} in {bench_path}")
        entry = entries[0]
        spec = load_json(HERE / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if spec[key] != entry[key]:
                raise SystemExit(f"workloads/{name}.json names {key} "
                                 f"{spec[key]!r}, BENCHMARK.json "
                                 f"{entry[key]!r}")
        return cls(name, entry, load_json(HERE / "configs" /
                                          f"{entry['config']}.json"),
                   load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                   spec, bench)

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those that list no cell and move a metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's configuration, traffic mix and
    spec, the run's seed, window length and tracing, the device, the
    process's start on the host clock, and the weights' calibration
    (set when the program is built, reused by the check)."""
    cfg: dict
    mix: dict
    spec: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    scales: dict | None = None


@dataclasses.dataclass
class Outcome:
    """What a run measured and checked.  ``e2e``: the end-to-end
    metrics the driver measures (``setup_s`` apart); ``spans``: per
    layer, the ms of each call in the window (traced runs);
    ``trace``: the profiled slice (traced runs); ``numbers``: the output
    check's numbers, held to ``limits``; ``counts``: what the window
    completed (for the per-layer readers)."""
    attempted: int
    failed: int
    setup_s: float
    window_s: float
    e2e: dict
    peak_bytes: int
    numbers: dict
    limits: dict
    counts: dict
    spans: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and compare.verdict(self.numbers,
                                                    self.limits)


def require_cards(chips: int) -> None:
    """Exit with :data:`NO_CARD` unless CUDA has ``chips`` cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(NO_CARD)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card: {out}"


def no_tf32() -> None:
    """float32 means float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def unit_seed(seed: int, unit: int, salt: int = 0) -> int:
    """The seed of a unit of work's inputs (salt 0) or of its streams'
    noise (salt 1 + stream): distinct for every (seed, unit, salt)."""
    return (seed * 1_000_003 + unit * 64 + salt) % (1 << 62)


def inputs(cfg: dict, n: int, seed: int, unit: int, device):
    """A unit's ``n`` images [n, H, W, 3] (standard normal, as a
    normalised image is) and, for a task that takes them, attention
    maps [n, mh, mw, 1] in [0, 1], from its seed on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        unit_seed(seed, unit))
    images = torch.randn((n, cfg["height"], cfg["width"], 3),
                         generator=gen, device=device)
    maps = None
    if cfg["task"] == "air":
        maps = torch.rand((n, cfg["map_height"], cfg["map_width"], 1),
                          generator=gen, device=device)
    return images, maps


def build_model(ctx: Context):
    """The program's ``ScanpathModel`` of the context's configuration,
    its weights the seed's (:func:`weights.make_state_dict`, their
    calibration kept in ``ctx.scales``) read through the program's own
    loader."""
    from scanpaths_tpu_torch.models.port import load_reference_state_dict
    from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
    cfg, device = ctx.cfg, ctx.device
    if cfg["dtype"] != "float32":
        raise ValueError(f"dtype {cfg['dtype']!r}: the harness builds "
                         "float32 configurations")
    sd, ctx.scales = weights.make_state_dict(cfg, ctx.seed, device,
                                             ctx.scales)
    with torch.device(device):
        net = ScanpathModel(cfg["task"], embed=cfg["embed"],
                            seq_len=cfg["max_length"],
                            map_h=cfg["map_height"], map_w=cfg["map_width"],
                            backbone_layers=tuple(cfg["backbone_layers"]))
    net.load_state_dict(load_reference_state_dict(sd, cfg["task"]))
    return net.eval()


def grid(cfg: dict):
    from scanpaths_tpu_torch.core.grid import GridSpec
    return GridSpec(map_width=cfg["map_width"], map_height=cfg["map_height"],
                    width=cfg["width"], height=cfg["height"],
                    max_length=cfg["max_length"],
                    min_length=cfg["min_length"])


class Spans:
    """Spans the benchmark opens around its calls into the program's
    layers.  With ``events`` each span records CUDA events, read once
    the window is over (:meth:`ms`); with ``profiling`` on, each also
    opens a ``record_function`` range, which a trace shows as the host's
    span.  Off, a span costs nothing."""

    def __init__(self, events: bool):
        self.events = events
        self.profiling = False
        self.pairs: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(f"bench:{name}") \
            if self.profiling else contextlib.nullcontext()
        with rf:
            if not self.events:
                yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.pairs.setdefault(name, []).append((start, end))

    def ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.pairs.items()}


def profile(spans: Spans, prepare, serve, first: int, units: int):
    """Runs ``units`` units from ``first`` under ``torch.profiler``: for
    each, ``serve(i, *prepare(i))`` in a span ``unit`` (the client's
    preparation of its inputs outside it), and returns the slice's
    :class:`yardstick.trace.Trace`."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from .yardstick.trace import read_profile
    torch.cuda.synchronize()
    spans.profiling, spans.events = True, False
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + units):
            args = prepare(i)
            with spans("unit"):
                serve(i, *args)
        torch.cuda.synchronize()
    spans.profiling = False
    return read_profile(prof, units)


def pick(seed: int, done: int, k: int) -> list[int]:
    """``k`` of the ``done`` units, drawn from the seed (all if fewer)."""
    return sorted(random.Random(seed).sample(range(done), min(k, done)))


def free() -> None:
    """Called once the program's state is dropped: returns its memory."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@torch.no_grad()
def check(ctx: Context, picked: list, n: int, rollouts: int | None,
          control_precision: str | None = None) -> dict:
    """The output check of the units ``picked``: a list of (unit index,
    one served dict a stream, as :func:`compare.judge` takes it).  The
    reference runs once over all their inputs, on the seed's weights
    made anew (with the program's calibration); a sampled decode (``rollouts``) redraws each stream's
    noise from its seed.  ``control_precision`` judges the control's
    outputs in that precision (:mod:`.reference.control`) in place of
    ``picked``'s (their indices alone are used).  Returns the worst of
    each number."""
    cfg, dev = ctx.cfg, ctx.device
    sd, ctx.scales = weights.make_state_dict(cfg, ctx.seed, dev, ctx.scales)
    batch = [inputs(cfg, n, ctx.seed, i, dev) for i, _ in picked]
    images = torch.cat([b[0] for b in batch])
    maps = None if batch[0][1] is None else torch.cat([b[1] for b in batch])
    ref = ref_model.forward(sd, cfg, images, maps)
    scales = compare.ranges(ref)
    gen = torch.Generator(device=dev)
    readings = []
    for k, (i, served) in enumerate(picked):
        rows = slice(k * n, (k + 1) * n)
        noises = None
        if rollouts is not None:
            noises = []
            for si in range(len(ref)):
                gen.manual_seed(unit_seed(ctx.seed, i, 1 + si))
                noises.append(sampler.noise(
                    gen, rollouts, ref[si]["logits"][rows].shape,
                    ref[si]["mu"][rows].shape, dev))
        if control_precision is not None:
            served = control.served(
                sd, cfg, images[rows],
                None if maps is None else maps[rows], noises,
                control_precision)
        for si, s in enumerate(served):
            r = {key: v[rows] for key, v in ref[si].items()}
            g, nrm = (None, None) if noises is None else noises[si]
            readings.append(compare.judge(r, s, cfg, scales, g, nrm))
    return compare.worst(readings)


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN
                  and sys.modules[m] is not None)


def served_dict(out: dict, stream, sample) -> dict:
    """The served outputs of one stream, in :func:`compare.judge`'s
    terms: the forward's distributions and the decode's scanpaths."""
    pre = f"{stream}_" if stream else ""
    return {"probs": out[pre + "all_actions_prob"],
            "mu": out[pre + "log_normal_mu"],
            "sigma2": out[pre + "log_normal_sigma2"],
            "actions": sample.actions, "durations": sample.durations,
            "fix": sample.fix, "fix_len": sample.fix_len}


def mark(ctx: Context, what: str) -> None:
    """Prints on standard error how far into the process a step of the
    set-up ended."""
    print(f"setup: {what} at {time.perf_counter() - ctx.t0:.2f} s",
          file=sys.stderr, flush=True)


# the port's kernels as a trace names them (csrc/cell.cu, csrc/block.cu)
KERNELS = {"cell": {"float32": "cell_f32", "bfloat16": "cell_bf16"},
           "stage": {"float32": "conv_f32<", "bfloat16": "conv_bf16<"}}


def kernel_name(kernel: str, cfg: dict) -> str:
    return KERNELS[kernel][cfg["dtype"]]


def checked_trace(outcome: Outcome, cfg: dict):
    """The run's profiled slice once it passes its check (every unit's
    decode steps launched the cell kernel, and the device time fits the
    slice), or None in an untraced run; raises for a trace that fails,
    since nothing read from it would be sound."""
    tr = outcome.trace
    if tr is None:
        return None
    problem = tr.problem((kernel_name("cell", cfg),),
                         cfg["max_length"] * tr.units)
    if problem is not None:
        raise RuntimeError(f"the profiled slice cannot be read: {problem}")
    return tr
