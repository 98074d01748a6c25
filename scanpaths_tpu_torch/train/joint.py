"""Joint multi-task training (port of ``scanpaths_tpu/train/joint.py``):
one model with a shared dilated ResNet-50 trunk and the three task heads
(``models/scanpath_model.py::JointScanpathModel``), trained over the
three task datasets, built from the single-task trainer's parts:

* ONE joint model and ONE optimizer (``steps.TrainState``) over all its
  parameters; each step runs one task's head through a ``TaskView``.
  Weight decay and Adam reach every parameter on every step, so a step
  of one task also moves the other heads (decay alone: their gradient is
  zero-filled), as the JAX package's optax chain does;
* the schedule's supervised and SCST step counts are the sums over the
  tasks; the tasks' batches come round-robin (OSIE, AiR, COCO, a task
  dropping out once its loader is exhausted): supervised steps before
  ``--start_rl_epoch``, SCST steps from it;
* a validation of every head after each epoch, on the host suite or the
  device sweep (``--device_eval``); the selection metric is the harmonic
  mean of the three per-task ScanMatch harmonic means;
* the artifacts of the single-task trainer (hparams.json, log_train.txt,
  history_record.json, scalars.jsonl, the checkpoint triad, the
  ``_supervised_save`` copy), the scalar tags prefixed ``<task>/`` but
  for ``learning_rate`` and ``current metric``; the checkpoints in the
  joint layout (``models/port.py::to_joint_reference_state_dict``), from
  which ``cli/test.py`` and ``cli/predict.py`` take one task's head.

One ``torch.Generator`` (seeded ``--seed``) draws the SCST rollouts and
the validation decodes in run order, as the JAX trainer splits one key
for both.  AiR's validation decodes both streams, good then poor, from
one eval forward.

Over ranks as the single-task trainer (``train/trainer.py``): each
rank loads its data rank's slice of every task's global batches, in the
same round-robin order (every rank draws the same shuffles); every rank
validates its rows of every head's split and rank 0 aggregates and
writes the run.  The idle heads' zero-filled gradients are reduced with
the others, so decay and Adam move them alike on every rank.  Under
``--model_parallel`` every head's two decode kernels are sliced over the
model group (``train/tp_step.py``).

Data layout under ``--joint_data_root`` (``tools/make_synth_data.py``'s):
  osie/stimuli osie/fixations
  air/stimuli air/fixations air/attention
  coco/images coco/fixations coco/detectors
"""

from __future__ import annotations

import time
from os.path import join

import scipy.stats
import torch

from ..data.datasets import DataConfig
from ..data.prefetch import prefetch
from ..models.port import (load_joint_reference_state_dict,
                           to_joint_reference_state_dict)
from ..models.scanpath_model import TaskView, init_weights, model_from_flags
from ..utils.checkpointing import restore_checkpoint
from . import mesh, steps, tp_step
from .trainer import (EvalCore, RunFiles, adam_step, check_ported_flags,
                      grid_spec, load_backbone, log_metric_tree, rl_config,
                      train_loaders)

TASKS = ("osie", "air", "coco")
SUPERVISED_TAGS = {k: f"loss/{k}" for k in ("loss", "loss_actions",
                                            "loss_duration")}


def task_data_config(args, task: str) -> DataConfig:
    """The data of one task under ``--joint_data_root``."""
    root = args.joint_data_root
    common = dict(action_map=(args.map_height, args.map_width),
                  resize=(args.height, args.width),
                  max_length=args.max_length, blur_sigma=args.blur_sigma,
                  cache_images=args.cache_images,
                  packed_cache_dir=args.packed_cache_dir or None)
    if task == "osie":
        return DataConfig(img_dir=join(root, "osie", "stimuli"),
                          fix_dir=join(root, "osie", "fixations"), **common)
    if task == "air":
        return DataConfig(img_dir=join(root, "air", "stimuli"),
                          fix_dir=join(root, "air", "fixations"),
                          att_dir=join(root, "air", "attention"), **common)
    return DataConfig(img_dir=join(root, "coco", "images"),
                      fix_dir=join(root, "coco", "fixations"),
                      att_dir=join(root, "coco", "detectors"),
                      detector_threshold=args.detector_threshold,
                      coco_split=args.coco_split, **common)


class TaskContext(EvalCore):
    """One task of a joint run: its loaders (seeded as the single-task
    trainer's; this rank's slice of each), its SCST settings
    and the evaluation plumbing over the joint model's head of the task,
    with the trainer's noise generator, logger and writer; its scalars
    are tagged ``<task>/``."""

    def __init__(self, trainer: "JointTrainer", task: str):
        args = trainer.args
        self.args, self.task, self.grid = args, task, trainer.grid
        self.device, self.generator = trainer.device, trainer.generator
        self.logger, self.writer = trainer.logger, trainer.writer
        self.tag_prefix = f"{task}/"
        self.model = TaskView(trainer.model, task)
        self.train_loader, self.train_rl_loader, self.validation_loader = \
            train_loaders(args, task, task_data_config(args, task))
        self.rl_cfg = rl_config(args, self.train_rl_loader.dataset, task)


def round_robin(loaders: dict):
    """(task, batch) pairs cycling through the tasks until every loader
    is exhausted."""
    live = {t: iter(loader) for t, loader in loaders.items()}
    while live:
        for t in list(live):
            try:
                yield t, next(live[t])
            except StopIteration:
                del live[t]


class JointTrainer(RunFiles):
    """The joint run of ``cli/train.py --task joint`` on ``device`` (the
    card unless the caller asks for the CPU), one rank of a data x model
    mesh when a process group is initialised (``train/mesh.py``)."""

    def __init__(self, args, device="cuda"):
        if args.task != "joint":
            raise ValueError(f"JointTrainer trains --task joint, not "
                             f"{args.task!r}")
        check_ported_flags(args)
        self.args = args
        self.grid = grid_spec(args)
        self.device = torch.device(device)
        self.mesh = mesh.current(self.device)
        self.open_run(args, "log_joint_")

        self.model = model_from_flags(args)
        init_weights(self.model, args.seed)
        if args.checkpoint:
            load_backbone(self.model.backbone, args.checkpoint, self.logger)
        # one noise stream for the SCST rollouts and the validation
        # decodes of every task
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(args.seed)
        self.tasks = {t: TaskContext(self, t) for t in TASKS}
        steps_sup = sum(len(c.train_loader) for c in self.tasks.values())
        steps_rl = sum(len(c.train_rl_loader) for c in self.tasks.values())

        opt_state, step = None, 0
        if args.resume_dir != "":
            restored = restore_checkpoint(self.checkpoints_dir)
            self.model.load_state_dict(
                load_joint_reference_state_dict(restored["model"]))
            opt_state = restored["optimizer"]
            step = adam_step(opt_state)
        self.state = tp_step.train_state_class().create(
            self.model, args, steps_sup, steps_rl, step=step,
            device=self.device, opt_state=opt_state)
        self.epoch_stats: dict = {}

    def _on(self, task: str) -> steps.TrainState:
        """The run's one TrainState, its model the view of ``task``'s head
        (the optimizer holds every parameter of the joint model)."""
        self.state.model = self.tasks[task].model
        return self.state

    def train_epoch(self, iteration: int, epoch: int) -> int:
        """One epoch over the three tasks' batches round-robin:
        supervised before ``--start_rl_epoch``, SCST from it, a prefetch
        thread assembling the batches and copying them to the device.
        Writes each step's scalars at its iteration.  ``self.epoch_stats``
        keeps per task the epoch's steps, the seconds its steps took
        (each step ends when its scalars are read), the images per step
        and the seconds the loop waited for its host batches."""
        args = self.args
        rl = epoch >= args.start_rl_epoch
        loaders = {t: (c.train_rl_loader if rl else c.train_loader)
                   for t, c in self.tasks.items()}
        batches = iter(prefetch(
            round_robin(loaders),
            lambda tb: (tb[0], steps.device_batch(
                tb[1], self.device, for_rl=rl,
                ablate_attention=args.ablate_attention_info)),
            depth=args.prefetch))
        self.model.train()
        stats = {t: dict(epoch=epoch, rl=rl, steps=0, seconds=0.0,
                         images_per_step=loaders[t].batch_size,
                         input_wait_seconds=0.0) for t in TASKS}
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            waited = time.perf_counter() - t0
            if item is None:
                break
            task, db = item
            ctx = self.tasks[task]
            # the lr this step applies (the JAX trainer's lr * lr_fn)
            lr = self.state.optimizer.param_groups[0]["lr"]
            if rl:
                metrics = steps.rl_step(self._on(task), db, ctx.rl_cfg,
                                        generator=self.generator)
                scalars = {k: v for k, v in metrics.items()
                           if k != "grad_norm"}
            else:
                metrics = steps.supervised_step(self._on(task), db,
                                                args.lambda_1)
                scalars = {tag: metrics[k]
                           for k, tag in SUPERVISED_TAGS.items()}
            iteration += 1
            for tag, val in scalars.items():
                self.writer.add_scalar(f"{task}/{tag}", val, iteration)
            self.writer.add_scalar("learning_rate", lr, iteration)
            st = stats[task]
            st["steps"] += 1
            st["seconds"] += time.perf_counter() - t0 - waited
            st["input_wait_seconds"] += waited
        self.epoch_stats = stats
        for task, st in stats.items():
            if st["seconds"] > 0:
                self.logger.info(
                    f"[{task}] epoch {epoch}: {st['steps']} steps in "
                    f"{st['seconds']:.1f}s "
                    f"({st['steps'] * st['images_per_step'] / st['seconds']:.1f}"
                    f" images/s; {st['input_wait_seconds']:.2f}s waiting for "
                    f"host batches)")
        return iteration

    # ------------------------------------------------------------------
    def validation(self, iteration: int, device_eval: bool = False) -> float:
        """Every head on its task's validation split (the device sweep
        with ``device_eval``, else the host suite): the metric scalars
        tagged ``<task>/metrics/...`` and the joint selection metric, the
        harmonic mean of the per-task ScanMatch harmonic means (written
        as ``current metric``, and returned)."""
        hmeans = []
        for task, ctx in self.tasks.items():
            metrics, stds, _ = ctx.evaluate(ctx.validation_loader,
                                            device_eval, iteration)
            hmeans.append(ctx.selection_metric(metrics))
            self.logger.info(
                f"[{task}] validation{' (device sweep)' if device_eval else ''}"
                f" after iteration {iteration}: ScanMatch hmean "
                f"{hmeans[-1]:.4f}")
            log_metric_tree(self.logger, metrics, stds, self.writer,
                            iteration, tag_prefix=f"{task}/")
        joint = float(scipy.stats.hmean(hmeans))
        self.writer.add_scalar("current metric", joint, iteration)
        return joint

    def human_baseline(self) -> None:
        """Each task's human inter-observer baseline on its validation
        split (on the device under ``--device_eval``)."""
        for task, ctx in self.tasks.items():
            metrics, stds = ctx.human_metrics(ctx.validation_loader,
                                              self.args.device_eval)
            self.logger.info(f"[{task}] metrics for human performance:")
            log_metric_tree(self.logger, metrics, stds)

    # ------------------------------------------------------------------
    def fit(self) -> float:
        args = self.args
        start_epoch = self.record_manager.get_epoch()
        iteration = self.record_manager.get_iteration()
        if args.resume_dir == "":
            self.human_baseline()
        for epoch in range(start_epoch + 1, args.epoch):
            iteration = self.train_epoch(iteration, epoch)
            # every rank validates its rows and takes rank 0's metrics
            cur = self.validation(iteration, args.device_eval)
            self.logger.info(f"joint metric: {cur:.4f}")
            state = tp_step.full_state_dict(self.model)
            model_state = (to_joint_reference_state_dict(
                state, self.model.map_h, self.model.map_w)
                if self.mesh.is_primary else None)
            self.end_epoch(epoch, cur, iteration, model_state)
        return self.close_run()
