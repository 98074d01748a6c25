"""Training driver of the PyTorch port (port of
``scanpaths_tpu/train/trainer.py``): the two-phase schedule (supervised,
then SCST from ``--start_rl_epoch``), a validation after every epoch,
the checkpoint triad, the run record and the scalars.

It follows the reference drivers' control flow (reference
OSIE/train.py:47-364, AiR/train.py:52-486, COCO_Search18/train.py) for
the three task plugins, as the JAX trainer does:

* artifacts: hparams.json, log_train.txt, history_record.json,
  scalars.jsonl (and TensorBoard event files where
  ``torch.utils.tensorboard`` imports), checkpoints/{checkpoint.pth,
  checkpoint_best.pth} in the reference's layout
  (``utils/checkpointing.py``; ``--ckpt_backend orbax`` writes them on
  a writer thread), the ``<logdir>_supervised_save`` copy at epoch
  ``start_rl_epoch - 1`` (after the epoch's writes land);
* the scalar tags are the JAX trainer's, which are the reference's
  TensorBoard tags;
* model selection is the harmonic mean of the ScanMatch metrics (AiR:
  over the right- and wrong-answer groups, reference
  AiR/train.py:467-468).

:class:`EvalCore` is the decode and evaluation plumbing that
:class:`Trainer` and :class:`Evaluator` (``cli/test.py``) share: the
eval forward, the sampler on an explicit ``torch.Generator``, and one
loop over an evaluation split that scores the rollouts on the device
(``--device_eval``, ``metrics/device_eval.py``, whose ScanMatch runs the
NW kernel) or with the host suite.  The eval forward is the kernels'
path (``ScanpathModel.forward``, no gradients); the training steps run
the stock-op forward (``train/steps.py``).

Over ranks (``cli/train.py`` and ``cli/test.py`` under torchrun,
``train/mesh.py``): every rank builds the same model from the seed and
loads its data rank's slice of each global ``--batch``, of the training
and of the evaluation splits (the ranks of a model group load the same
rows); every rank takes the same steps (``train/steps.py`` makes them
global; under ``--model_parallel`` over the sliced state of
``train/tp_step.py``).  The human baseline and every validation run on
every rank: each decodes and scores its rows, drawing the sampler's
noise for the global batch and keeping its rows, so the ranks' draws are
one process's; rank 0 gathers the scored rows in one process's order,
aggregates and logs them, and every rank takes its metrics, so every
rank selects alike.  Rank 0 alone writes the run (hparams.json,
log_train.txt, the scalars, the record, the checkpoints, gathered whole
under TP, the ``_supervised_save`` copy); its log dir name is broadcast.
The ranks meet at a barrier after each checkpoint write (after its
enqueue under ``--ckpt_backend orbax``; the writes land before the
barrier of ``close_run``); a resume restores rank 0's files on every
rank.
"""

from __future__ import annotations

import datetime
import functools
import json
import logging
import os
import shutil
import sys
import time
from os.path import join

import numpy as np
import scipy.stats
import torch

from ..core.grid import GridSpec
from ..data.datasets import (DataConfig, EvaluationDataset, Loader,
                             SupervisedDataset, batches_of)
from ..data.prefetch import prefetch
from ..metrics import evaluation as heval
from ..metrics import torch_metrics as tm
from ..metrics.device_eval import DeviceSweep, human_evaluation_device
from ..models import resnet
from ..models.port import load_reference_state_dict, to_reference_state_dict
from ..models.scanpath_model import init_weights, model_from_flags
from ..ops import sampling
from ..ops.sampling import to_fix_vectors
from ..serve.predictor import Predictor, eval_forward, trained_task
from ..utils.checkpointing import (make_checkpoint_manager,
                                   restore_checkpoint)
from ..utils.logger import Logger, task_log_level
from ..utils.recording import RecordManager
from . import mesh, steps, tp_step

# (stream, the answer-correctness flag its rollouts are scored under) of
# each decode of a batch: AiR decodes its good and poor streams from one
# eval forward, the other tasks their one stream
STREAMS = {"air": (("good", True), ("poor", False))}
ONE_STREAM = ((None, None),)
# the host fields of an evaluation batch the host suite's human baseline
# reads
HUMAN_KEYS = ("fix_vectors", "img_names", "performances", "question_ids")


class ScalarWriter:
    """TensorBoard SummaryWriter when available, JSONL always."""

    def __init__(self, log_dir: str):
        self.jsonl = open(join(log_dir, "scalars.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir=log_dir)
        except ImportError as e:
            # say so ONCE (scalars.jsonl still records everything)
            print(f"[ScalarWriter] TensorBoard unavailable ({e}); scalars "
                  "go to scalars.jsonl only", file=sys.stderr)

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self.jsonl.write(json.dumps({"tag": tag, "value": value,
                                     "step": int(step)}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class NoScalars:
    """The writer of a rank other than 0: writes nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def close(self):
        pass


def run_logger(m: mesh.Mesh, log_file: str, level=logging.INFO):
    """Rank 0's file and console logger of ``log_file``; another rank's
    logger writes nothing."""
    if m.is_primary:
        return Logger(log_file, level=level)
    logger = logging.getLogger(f"{log_file}.rank{m.rank}")
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def run_log_dir(args, prefix: str) -> str:
    """The run's directory: ``--resume_dir``, else
    ``<log_root>/<prefix><date>``, rank 0's name on every rank (the
    minute can turn between the ranks' clocks)."""
    if args.resume_dir != "":
        return args.resume_dir
    date = str(datetime.datetime.now())
    date = date[:date.rfind(":")].replace("-", "") \
        .replace(":", "").replace(" ", "_")
    return mesh.broadcast_str(join(args.log_root, prefix + date))


def data_config(args) -> DataConfig:
    att_dir = args.att_dir if args.task == "air" else args.detector_dir
    return DataConfig(
        img_dir=args.img_dir, fix_dir=args.fix_dir, att_dir=att_dir,
        action_map=(args.map_height, args.map_width),
        resize=(args.height, args.width), max_length=args.max_length,
        blur_sigma=args.blur_sigma,
        detector_threshold=args.detector_threshold,
        coco_split=args.coco_split, cache_images=args.cache_images,
        packed_cache_dir=args.packed_cache_dir or None)


def grid_spec(args) -> GridSpec:
    return GridSpec(map_width=args.map_width, map_height=args.map_height,
                    width=args.width, height=args.height,
                    max_length=args.max_length, min_length=args.min_length)


def wd_table_symbols(ds: EvaluationDataset) -> int:
    """The w/-duration ScanMatch NW table's static bound for a split:
    ``ceil(max(wd_symbols_needed, 256) / 64) * 64`` symbols, so no
    ground-truth symbol expansion is cut."""
    return int(np.ceil(max(ds.wd_symbols_needed, 256) / 64) * 64)


def eval_specs(ds, grid: GridSpec):
    """Static ScanMatch specs for the device sweep, table bounds derived
    from the split: the w/-duration table holds :func:`wd_table_symbols`,
    the w/o-duration table ``max(T, pad_gt_len)``.  Sampled rollouts
    whose TempBin expansion passes the w/-duration bound are
    prefix-truncated (durations are unbounded LogNormals) and counted by
    the ``DeviceSweep`` overflow counter.  The bins are the FIXED
    evaluation protocol (16x12 over 320x240, reference
    AiR/train.py:216-218), not the configured image geometry, as in the
    host suite."""
    spec_wd = tm.ScanMatchSpec(temp_bin=50.0,
                               max_symbols=wd_table_symbols(ds))
    spec_wod = tm.ScanMatchSpec(
        temp_bin=0.0, max_symbols=max(grid.max_length, ds.pad_gt_len))
    return spec_wd, spec_wod


def rl_config(args, rl_ds: EvaluationDataset,
              task: str | None = None) -> steps.RLConfig:
    """The SCST settings of a run (of ``task``, default ``--task``), the
    NW tables' static bounds from its RL split (the train split's
    evaluation view), so that no ground-truth symbol expansion is cut:
    :func:`wd_table_symbols` with duration, ``pad_gt_len`` without.  A
    sampled rollout past the bound is counted in
    ``reward_overflow_frac``."""
    return steps.RLConfig(task=task or args.task, grid=grid_spec(args),
                          rl_sample_number=args.rl_sample_number,
                          max_symbols_wd=wd_table_symbols(rl_ds),
                          max_symbols_wod=rl_ds.pad_gt_len,
                          apply_cd=args.apply_consistency_divergence,
                          lambda_5=args.lambda_5)


def log_metric_tree(logger, metrics, stds, writer=None, iteration: int = 0,
                    tag_prefix: str = ""):
    """Reference-format metric printout (``<group>-<metric>: m +- s``
    rows, reference OSIE/train.py:326-338); with ``writer``, each value
    also as the scalar ``<tag_prefix>metrics/<group>-<metric>``."""
    def walk(m, s, prefix):
        for k, v in m.items():
            if isinstance(v, dict):
                walk(v, s[k], prefix + [k])
                continue
            if writer is not None:
                writer.add_scalar(tag_prefix + "metrics/"
                                  + "-".join(prefix + [k]), v, iteration)
            logger.info(f"{'-'.join(prefix):24}-{k:15}: {v:.4f} "
                        f"+- {s[k]:.4f}")
    walk(metrics, stds, [])


def check_ported_flags(args) -> None:
    """Raise for ``--stem_impl s2d``, which the port leaves out, and for
    a ``--mesh_size`` or ``--model_parallel`` the launch does not give
    (``mesh.check_mesh_size``, ``mesh.check_model_parallel``)."""
    if args.stem_impl == "s2d":
        raise NotImplementedError(
            "--stem_impl s2d: the space-to-depth stem is TPU machinery the "
            "port leaves out (ROADMAP, North star)")
    mesh.check_model_parallel(args.model_parallel,
                              mesh.check_mesh_size(args.mesh_size))


def load_backbone(backbone: resnet.DilatedResNet50, path: str,
                  logger) -> None:
    """Warm-start a ResNet-50 trunk from a torchvision-layout state dict
    (``--checkpoint``; the reference auto-downloads
    https://download.pytorch.org/models/resnet50-19c8e357.pth,
    AiR/models/resnet.py:179); the sha256 prefix a torchvision filename
    embeds must match the content."""
    if not resnet.verify_torchvision_sha(path):
        raise ValueError(
            f"{path}: content does not match the sha256 prefix in its "
            "filename (corrupted download?)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    backbone.load_state_dict(resnet.load_torch_state_dict(sd,
                                                          backbone.layers))
    logger.info("Loaded pretrained backbone from %s", path)


class EvalCore:
    """Shared decode and evaluation plumbing over ``self.model`` (eval
    forward), ``self.generator`` (the sampler's noise), ``self.device``,
    ``self.logger`` and ``self.writer`` (None: no scalars), whose tags
    start with ``self.tag_prefix``."""

    args: object
    task: str
    grid: GridSpec
    model: torch.nn.Module
    device: torch.device
    generator: torch.Generator
    logger: object
    writer: ScalarWriter | None = None
    tag_prefix: str = ""

    def forward(self, batch: dict) -> dict:
        """The eval forward (no gradients, through the kernels on a card)
        of a host batch with its attention maps and task ids."""
        return eval_forward(self.model, self.device,
                            self.args.ablate_attention_info,
                            batch["images"], batch.get("attention_maps"),
                            batch.get("tasks"))

    def sample(self, out: dict, repeat_num: int, stream: str | None,
               sliced: bool = False):
        """``repeat_num`` scanpaths per image from one stream's eval
        outputs, drawn from ``self.generator``; every leaf leads with
        [R].  For a ``sliced`` batch (this data rank's rows of a global
        one) the noise is drawn for the global batch and this rank keeps
        its rows, so the ranks draw one process's noise."""
        pre = f"{stream}_" if stream else ""
        probs, mu = out[pre + "all_actions_prob"], out[pre + "log_normal_mu"]
        n = probs.shape[0]
        noise = sampling.sample_noise(
            probs, mu, self.generator, repeat_num,
            batch=n * mesh.data_size() if sliced else n)
        if sliced:
            noise = [mesh.slice_rows(z, 1) for z in noise]
        return sampling.random_sample_from_noise(
            probs, mu, out[pre + "log_normal_sigma2"], self.grid, *noise)

    def decode_batch_device(self, batch, repeat_num: int, streams=(None,),
                            sliced: bool = False):
        """One eval forward of a host batch, then ``repeat_num``
        stochastic decodes of each stream in ``streams`` (``"good"`` /
        ``"poor"`` read the AiR outputs of that prefix; both streams come
        from one forward; ``sliced`` as in :meth:`sample`).  Returns the
        batch's ground truth as device tensors (``gt_fix``, ``gt_len``,
        ``gt_mask``) and the samples of each stream ([R, N, ...] leaves,
        on the device), which the device sweep consumes as they are."""
        db = {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
              for k in ("gt_fix", "gt_len", "gt_mask")}
        out = self.forward(batch)
        return db, [self.sample(out, repeat_num, s, sliced) for s in streams]

    def decode_batch(self, batch, repeat_num: int, stream=None):
        """Eval forward + ``repeat_num`` stochastic decodes of one stream;
        a list (repeat-major) of per-image fixation vectors."""
        _, (samples,) = self.decode_batch_device(batch, repeat_num,
                                                 (stream,))
        return to_fix_vectors(samples)

    def human_metrics(self, loader, device_eval: bool):
        """The human inter-observer baseline of an evaluation split:
        (metrics, stds), on the device under ``device_eval``.  Over ranks
        each rank scores its rows on the device, or with the host suite
        rank 0 scores every rank's rows; every rank returns rank 0's
        result."""
        if device_eval:
            spec_wd, spec_wod = eval_specs(loader.dataset, self.grid)
            metrics, stds, _ = human_evaluation_device(
                loader, spec_wd, spec_wod, task=self.task,
                device=self.device)
            return metrics, stds
        chunks = [((b, mesh.row_offset(sliced, len(batch["fix_vectors"]))),
                   {k: batch[k] for k in HUMAN_KEYS if k in batch})
                  for b, (batch, sliced) in enumerate(batches_of(loader))
                  if mesh.counts_rows(sliced)]
        gathered = mesh.gather_to_primary(chunks)
        result = None if gathered is None else heval.human_evaluation(
            [rows for _, rows in gathered], task=self.task)[:2]
        return mesh.broadcast_object(result)

    def evaluate(self, loader, device_eval: bool, iteration: int = 0,
                 record=None):
        """Decode every batch of ``loader`` ``eval_repeat_num`` times per
        stream (one eval forward a batch) and score the rollouts against
        the batch's ground truth: every pairwise metric on the device
        with ``device_eval`` (the ``DeviceSweep``, whose overflow counter
        becomes the ``metrics/wd_overflow_frac`` scalar at
        ``iteration``), else with the host suite (bucketed by answer
        correctness for AiR).  ``record(batch, flag, r, preds)``, when
        given, returns the records of each repeat's per-image fixation
        vectors.  The model is in eval mode for the loop, its sliced
        kernels gathered whole (``tp_step.gathered``), and back in its
        previous mode after it.

        Over ranks each rank decodes its rows of every batch (the ranks
        of a model group the same rows; a batch every rank holds whole
        counts on data rank 0) and scores the rows it counts
        (``mesh.counts_rows``); rank 0 gathers the scored rows (or the
        host suite's inputs) and the records in one process's order and
        aggregates.  Returns (metrics, stds) on every rank and the
        records, in one process's order on rank 0 (empty elsewhere)."""
        repeat = self.args.eval_repeat_num
        streams = STREAMS.get(self.task, ONE_STREAM)
        air = self.task == "air"
        sweep = (DeviceSweep(*eval_specs(loader.dataset, self.grid))
                 if device_eval else None)
        host, records = [], []
        was_training = self.model.training
        self.model.eval()
        try:
            with tp_step.gathered(self.model):
                for b, (batch, sliced) in enumerate(batches_of(loader)):
                    n = len(batch["fix_vectors"])
                    db, per_stream = self.decode_batch_device(
                        batch, repeat, [s for s, _ in streams], sliced)
                    if not mesh.counts_rows(sliced):
                        continue
                    first = mesh.row_offset(sliced, n)
                    for si, ((_, flag), samples) in enumerate(
                            zip(streams, per_stream)):
                        preds = (to_fix_vectors(samples)   # repeat-major
                                 if sweep is None or record is not None
                                 else None)
                        for r in range(repeat):
                            key = (b, si, r, first)
                            mine = None if preds is None \
                                else preds[r * n:(r + 1) * n]
                            if sweep is not None:
                                # pairwise metrics stay on the device;
                                # the host only aggregates
                                gt = (db["gt_fix"], db["gt_len"],
                                      db["gt_mask"], samples.fix[r],
                                      samples.fix_len[r])
                                if air:
                                    sweep.add_batch_air(
                                        *gt, batch["performances"], flag,
                                        key=key)
                                else:
                                    sweep.add_batch(*gt, key=key)
                            else:
                                host.append((key, (
                                    batch["fix_vectors"], mine,
                                    batch["performances"] if air else None,
                                    flag)))
                            if record is not None:
                                records.append((key, record(batch, flag, r,
                                                            mine)))
        finally:
            self.model.train(was_training)
        records = [rec for _, recs in mesh.gather_to_primary(records) or ()
                   for rec in recs]
        if sweep is not None:
            metrics, stds = sweep.result()
            sweep.log_overflow(
                self.logger, self.writer,
                tag=f"{self.tag_prefix}metrics/wd_overflow_frac",
                step=iteration)
            return metrics, stds, records
        gathered = mesh.gather_to_primary(host)
        result = None
        if gathered is not None:
            all_gt, all_pred, all_perf, all_alloc = [], [], [], []
            for _, (gts, preds, perfs, flag) in gathered:
                all_gt.extend(gts)
                all_pred.extend(preds)
                if air:
                    all_perf.extend(perfs)
                    all_alloc.extend([flag] * len(gts))
            result = (heval.evaluation_performance_related(
                all_gt, all_pred, all_perf, all_alloc) if air
                else heval.evaluation(all_gt, all_pred))[:2]
        metrics, stds = mesh.broadcast_object(result)
        return metrics, stds, records

    def selection_metric(self, cur_metrics) -> float:
        if self.task == "air":
            vals = (list(cur_metrics["right_answer"]["ScanMatch"].values())
                    + list(cur_metrics["wrong_answer"]["ScanMatch"].values()))
        else:
            vals = list(cur_metrics["ScanMatch"].values())
        return float(scipy.stats.hmean(vals))


class Evaluator(EvalCore):
    """Inference-only driver for ``cli/test.py``: the model with the
    run's best checkpoint (``<log_dir>/checkpoints/checkpoint_best.pth``,
    reference layout, loaded by ``serve/predictor.py``; of a joint run,
    the ``--task`` head) on an explicit device, its sampler seeded by
    ``--seed``, and the logger of ``<log_dir>/log_test.txt`` (rank 0's;
    one rank of ``cli/test.py`` under torchrun when a process group is
    initialised, ``train/mesh.py``: each rank holds the whole model, and
    under ``--model_parallel`` the ranks of a model group decode the same
    rows); no train loaders and no optimizer (the reference test drivers
    touch only the eval split, AiR/test.py:60-104)."""

    def __init__(self, args, log_dir: str, device):
        self.args = args
        self.task = args.task
        self.grid = grid_spec(args)
        self.device = torch.device(device)
        self.mesh = mesh.current(self.device)
        self.logger = run_logger(self.mesh, join(log_dir, "log_test.txt"),
                                 level=task_log_level(args.task))
        if trained_task(log_dir, args.task) == "joint":
            self.logger.info("Evaluating the %s head of a joint checkpoint",
                             self.task)
        # the predictor loads the best checkpoint of --evaluation_dir
        predictor = Predictor(
            type(args)(**{**vars(args), "evaluation_dir": log_dir}),
            self.device)
        self.model = predictor.model
        self.generator = predictor.generator


def rank_slice() -> dict:
    """The ``Loader`` arguments of this rank's slice of each global batch:
    its data rank's (the ranks of a model group load the same rows)."""
    return dict(process_index=mesh.data_index(),
                process_count=mesh.data_size())


def train_loaders(args, task: str, cfg: DataConfig):
    """The supervised, SCST and validation loaders of ``task``, each
    loading this rank's slice of every global batch."""
    sup = Loader(SupervisedDataset(task, cfg, split="train"),
                 batch_size=args.batch, shuffle=True, seed=args.seed,
                 drop_last=True, **rank_slice())
    rl = Loader(EvaluationDataset(task, cfg, split="train"),
                batch_size=max(args.batch // 4, 1), shuffle=True,
                seed=args.seed + 1, drop_last=True, **rank_slice())
    val = Loader(EvaluationDataset(task, cfg, split="validation"),
                 batch_size=args.batch, shuffle=False, **rank_slice())
    return sup, rl, val


class RunFiles:
    """The writing side of a run shared by the two trainers:
    ``log_dir``, ``checkpoints_dir``, hparams.json, ``logger``,
    ``writer``, ``record_manager`` and, on rank 0, ``checkpoint_manager``
    (None elsewhere)."""

    def open_run(self, args, prefix: str, level=logging.INFO) -> None:
        primary = self.mesh.is_primary
        self.log_dir = run_log_dir(args, prefix)
        self.checkpoints_dir = join(self.log_dir, "checkpoints")
        if primary:
            os.makedirs(self.checkpoints_dir, exist_ok=True)
            if args.resume_dir == "":
                with open(join(self.log_dir, "hparams.json"), "w") as f:
                    json.dump(dict(vars(args)), f, indent=2)
        self.logger = run_logger(self.mesh,
                                 join(self.log_dir, "log_train.txt"), level)
        self.logger.info("The args corresponding to training process are: ")
        for key, value in vars(args).items():
            self.logger.info(f"{key:20}: {value}")
        self.logger.info(self.mesh.describe())
        self.writer = ScalarWriter(self.log_dir) if primary else NoScalars()
        self.record_manager = RecordManager(self.log_dir)
        self.checkpoint_manager = None
        if args.resume_dir != "":
            mesh.barrier()   # the resumed run's files are complete
            self.record_manager.load()
        elif primary:
            self.record_manager.init_record()
        if primary:
            self.checkpoint_manager = make_checkpoint_manager(
                self.checkpoints_dir, mode="max",
                best_metric=self.record_manager.get_best_metric(),
                backend=args.ckpt_backend)

    def end_epoch(self, epoch: int, metric: float, iteration: int,
                  model_state: dict | None) -> None:
        """Rank 0 writes the checkpoint triad of an epoch (the model in
        its reference layout, ``model_state``, the Adam state_dict, each
        whole under TP), the record and, at epoch ``start_rl_epoch - 1``,
        the ``_supervised_save`` copy; then every rank meets at a
        barrier.  The ranks' generators need no broadcast: every rank
        draws the same shapes (the global batch's noise) in the same
        order, in the steps and in the validations."""
        args = self.args
        opt_state = tp_step.full_optimizer_state(self.state.optimizer)
        if self.mesh.is_primary:
            self.checkpoint_manager.step(metric, model_state, opt_state)
            self.record_manager.save(
                epoch, iteration, self.checkpoint_manager.get_best_metric())
            if args.supervised_save and epoch == args.start_rl_epoch - 1:
                self.checkpoint_manager.wait()
                dst = self.log_dir.rstrip("/") + "_supervised_save"
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                shutil.copytree(self.log_dir, dst)
        mesh.barrier()

    def close_run(self):
        """Closes the scalar writer and the checkpoint manager (its
        writes land before the barrier); every rank returns the record's
        best metric."""
        self.writer.close()
        if self.checkpoint_manager is not None:
            self.checkpoint_manager.close()
        mesh.barrier()
        if not self.mesh.is_primary:
            self.record_manager.load()
        return self.record_manager.get_best_metric()


class Trainer(RunFiles, EvalCore):
    """The training run of ``cli/train.py`` on ``device`` (the card unless
    the caller asks for the CPU), one rank of a data x model mesh when a
    process group is initialised (``train/mesh.py``)."""

    def __init__(self, args, device="cuda"):
        check_ported_flags(args)
        self.args = args
        self.task = args.task
        self.grid = grid_spec(args)
        self.device = torch.device(device)
        self.mesh = mesh.current(self.device)

        # ---------------- log dir & artifacts ----------------
        self.open_run(args, "log_", task_log_level(args.task))
        if args.remat not in (False, "none"):
            self.logger.info(f"--remat {args.remat}: not applied (it "
                             "changes memory, not values)")

        # ---------------- data ----------------
        self.train_loader, self.train_rl_loader, self.validation_loader = \
            train_loaders(args, self.task, data_config(args))

        # ---------------- model / optimizer ----------------
        self.model = model_from_flags(args)
        init_weights(self.model, args.seed)
        if args.checkpoint:
            load_backbone(self.model.backbone, args.checkpoint, self.logger)
        opt_state, step = None, 0
        if args.resume_dir != "":
            restored = restore_checkpoint(self.checkpoints_dir)
            self.model.load_state_dict(
                load_reference_state_dict(restored["model"], self.task))
            opt_state = restored["optimizer"]
            step = adam_step(opt_state)
        # the schedule and Adam's bias correction go on from the saved
        # step count: make_optimizer offsets the LambdaLR by it and takes
        # the saved moments, while the lr comes from this run's flags
        # (the saved param_groups hold the old schedule's lr, which
        # differs when --epoch changes)
        self.state = tp_step.train_state_class().create(
            self.model, args, len(self.train_loader),
            len(self.train_rl_loader), step=step, device=self.device,
            opt_state=opt_state)
        self.rl_cfg = rl_config(args, self.train_rl_loader.dataset)
        if self.train_rl_loader.dataset.wd_symbols_needed > 256:
            self.logger.info(
                "ScanMatch w/-duration NW tables sized to %d symbols "
                "(split needs %d)", self.rl_cfg.max_symbols_wd,
                self.train_rl_loader.dataset.wd_symbols_needed)
        # one noise stream for the SCST rollouts and the validation
        # decodes, as the JAX trainer splits one key for both
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(args.seed)
        self._profiler = None
        self.epoch_stats: dict = {}

    # ------------------------------------------------------------------
    def _maybe_profile(self, iteration: int):
        """Opt-in ``torch.profiler`` trace of iterations 3-8 into
        ``--profile_dir`` (a Chrome trace, ``trace_<iteration>.json``), on
        rank 0."""
        pdir = self.args.profile_dir
        if not pdir or not self.mesh.is_primary:
            return
        if iteration == 3 and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            self.logger.info("torch.profiler trace started -> %s", pdir)
        elif iteration >= 8 and self._profiler is not None:
            self._profiler.stop()
            os.makedirs(pdir, exist_ok=True)
            path = join(pdir, f"trace_{iteration}.json")
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            self.logger.info("torch.profiler trace stopped -> %s", path)

    def train_epoch(self, iteration: int, epoch: int) -> int:
        """One epoch: supervised before ``--start_rl_epoch``, SCST from
        it, over batches that a prefetch thread assembles and copies to
        the device ahead of the steps.  Writes each step's scalars at its
        iteration and the epoch's steady-state rates (the first step
        left out).  ``self.epoch_stats`` keeps the epoch's steps, wall
        seconds, steady steps/s, images per step and the seconds the loop
        waited for the host's batches."""
        args = self.args
        rl = epoch >= args.start_rl_epoch
        loader = self.train_rl_loader if rl else self.train_loader
        images_per_step = loader.batch_size
        batches = iter(prefetch(
            loader, functools.partial(
                steps.device_batch, device=self.device, for_rl=rl,
                ablate_attention=args.ablate_attention_info),
            depth=args.prefetch))
        self.model.train()
        t0 = time.perf_counter()
        t_first = None  # after step 1, which the steady rate leaves out
        n_steps0 = iteration
        waited = 0.0
        while True:
            tw = time.perf_counter()
            db = next(batches, None)
            waited += time.perf_counter() - tw
            if db is None:
                break
            # the lr this step applies (the scalar the JAX trainer writes
            # as lr * lr_fn(iteration), read here from the optimizer)
            lr = self.state.optimizer.param_groups[0]["lr"]
            if rl:
                metrics = steps.rl_step(self.state, db, self.rl_cfg,
                                        generator=self.generator)
                scalars = {k: v for k, v in metrics.items()
                           if k != "grad_norm"}
            else:
                metrics = steps.supervised_step(self.state, db,
                                                args.lambda_1)
                scalars = {f"loss/{k}": metrics[k] for k in
                           ("loss", "loss_actions", "loss_duration")}
            iteration += 1
            self._maybe_profile(iteration)
            for tag, val in scalars.items():
                self.writer.add_scalar(tag, val, iteration)
            self.writer.add_scalar("learning_rate", lr, iteration)
            if t_first is None:
                t_first = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        dt = t_end - t0
        n = iteration - n_steps0
        if n > 1 and t_end > t_first:
            rate = (n - 1) / (t_end - t_first)
        elif n > 0 and dt > 0:
            rate = n / dt
        else:
            rate = 0.0
        self.epoch_stats = dict(epoch=epoch, rl=rl, steps=n, seconds=dt,
                                steps_per_sec=rate,
                                images_per_step=images_per_step,
                                input_wait_seconds=waited)
        if rate > 0:
            self.writer.add_scalar("perf/steps_per_sec", rate, iteration)
            self.writer.add_scalar("perf/images_per_sec",
                                   rate * images_per_step, iteration)
            self.logger.info(
                f"epoch {epoch}: {n} steps in {dt:.1f}s "
                f"({rate:.2f} steps/s steady, "
                f"{rate * images_per_step:.1f} images/s; "
                f"{waited:.2f}s waiting for host batches)")
        return iteration

    # ------------------------------------------------------------------
    def validation(self, iteration: int):
        """The validation split scored by the host suite."""
        metrics, stds, _ = self.evaluate(self.validation_loader, False,
                                         iteration)
        self.logger.info(f"Evaluation metrics after iteration {iteration}:")
        log_metric_tree(self.logger, metrics, stds, self.writer, iteration)
        return metrics

    def validation_device(self, iteration: int):
        """The validation split with every pairwise metric on the device
        (``metrics/device_eval.py``); the host suite's aggregation."""
        metrics, stds, _ = self.evaluate(self.validation_loader, True,
                                         iteration)
        self.logger.info(f"Evaluation metrics (device sweep) after "
                         f"iteration {iteration}:")
        log_metric_tree(self.logger, metrics, stds, self.writer, iteration)
        return metrics

    def human_baseline(self):
        metrics, stds = self.human_metrics(self.validation_loader,
                                           self.args.device_eval)
        self.logger.info("The metrics for human performance are: ")
        log_metric_tree(self.logger, metrics, stds)
        return metrics

    # ------------------------------------------------------------------
    def fit(self):
        args = self.args
        start_epoch = self.record_manager.get_epoch()
        iteration = self.record_manager.get_iteration()

        if args.resume_dir == "":
            self.human_baseline()

        for epoch in range(start_epoch + 1, args.epoch):
            iteration = self.train_epoch(iteration, epoch)
            # every rank validates its rows and takes rank 0's metrics
            cur_metrics = (self.validation_device(iteration)
                           if args.device_eval
                           else self.validation(iteration))
            cur_metric = self.selection_metric(cur_metrics)
            self.writer.add_scalar("current metric", cur_metric, iteration)
            self.logger.info(f"{'current metric':10}: {cur_metric:.4f}")
            state = tp_step.full_state_dict(self.model)
            model_state = (to_reference_state_dict(
                state, self.task, self.model.map_h, self.model.map_w)
                if self.mesh.is_primary else None)
            self.end_epoch(epoch, cur_metric, iteration, model_state)
        return self.close_run()


def adam_step(opt_state: dict) -> int:
    """The optimizer step count a saved torch Adam ``state_dict`` holds
    (every parameter's state counts the same steps; 0 when empty)."""
    for st in opt_state["state"].values():
        return int(st["step"])
    return 0
