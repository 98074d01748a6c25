"""The supervised and SCST (self-critical RL) training steps, all tasks
(port of ``scanpaths_tpu/train/steps.py``).

Each step is the model's stock-op forward (``ScanpathModel.forward_train``;
the cell and stage kernels define no backward), the loss, ``backward``,
the global-norm clip and an Adam step (:class:`TrainState`).  The SCST
reward stays on the device: the rollouts are sampled there
(``ops.sampling``), scored against every ground-truth subject by
``metrics.torch_metrics`` (ScanMatch through the NW kernel,
``ops/nw.py`` -> ``csrc/nw.cu``, on a CUDA tensor), shaped and
baselined there, without gradients (the JAX package's
``stop_gradient``).

Reference semantics kept, as in the JAX package:

* the SCST forward runs in eval mode: BN on the running statistics and
  softmaxed probabilities (reference OSIE/train.py:199), with gradients;
* the reward is the harmonic mean of the ScanMatch w/o- and w/-duration
  means over the ground-truth subjects; OSIE and COCO normalise by the
  TOTAL subject count with MultiMatch-NaN pairs voided (OSIE
  utils/evaluation.py:296-335), AiR normalises its same- and
  different-answer groups by the VALID pair count (AiR
  utils/evaluation.py:410-420);
* the baseline is the mean reward over the rollouts (OSIE/train.py:254;
  per stream for AiR, AiR/train.py:304-307);
* the loss is a plain sum over rollouts and samples of -log pi *
  advantage, for actions and durations (OSIE/train.py:256-258).

The reference rejects and resamples a whole rollout batch when any
sample's reward is NaN (OSIE/train.py:237-239); here, as in the JAX
package, an invalid (rollout, sample) entry gets zero advantage and is
left out of the baseline (the masked expectation of the same
estimator).  The AiR Consistency-Divergence term is computed but enters
the loss only with ``apply_cd`` (the reference drops it,
AiR/train.py:332-340).

The steps update the :class:`TrainState` in place and return their
metrics as 0-dim tensors on the model's device (read them when needed:
reading one waits for the step).

Under data parallel (``train/mesh.py``) each rank steps on its rows of
the global batch and the step is the global one, as under the JAX
package's mesh: every loss is a local numerator over a global
denominator (``losses.py``), the gradients are summed over the ranks
before the clip (so ``grad_norm`` and the clip are global), BN takes the
global batch's statistics (``models/resnet.py``), the metrics reduce
their numerators and denominators, not their ratios, and the SCST noise
is drawn for the global batch on every rank from a generator seeded
alike, each rank keeping its rows, so N ranks sample one process's
rollouts.  Every reduction is over the data ranks (``mesh``'s data
group); with one data rank each is the identity.  Under row-parallel
tensor parallelism (``train/tp_step.py``) the same steps drive a
``TPTrainState``: the model ranks of one data rank hold the same rows,
draw the same rollouts and compute the same losses, and the state's
clip takes the global norm over the sliced kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.grid import GridSpec
from ..metrics import torch_metrics as tm
from ..ops.sampling import random_sample_from_noise, sample_noise
from . import losses, mesh
from .schedule import make_optimizer

# the batch fields each step reads (the JAX Trainer's _device_batch)
SUPERVISED_KEYS = ("images", "scanpaths", "durations", "action_masks",
                   "duration_masks", "attention_maps", "performances",
                   "tasks")
RL_KEYS = ("images", "gt_fix", "gt_len", "gt_mask", "attention_maps",
           "tasks", "gt_performance")
MULTIMATCH_NAMES = ("vector", "direction", "length", "position", "duration")


def device_batch(batch: dict, device, for_rl: bool,
                 ablate_attention: bool = False) -> dict:
    """The fields a step reads (``RL_KEYS`` from an ``EvaluationDataset``
    batch, else ``SUPERVISED_KEYS`` from a ``SupervisedDataset`` one) as
    tensors on ``device``; AiR's ``performances`` as float32, the
    attention maps zeroed under ``ablate_attention``.  For a CUDA device
    each field is staged in pinned host memory and copied with
    ``non_blocking=True`` on the calling thread's current stream (the
    trainer's prefetch thread issues them on the default stream, which
    orders them before the steps that read them)."""
    pin = torch.device(device).type == "cuda"
    out = {}
    for k in RL_KEYS if for_rl else SUPERVISED_KEYS:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        if k == "performances":
            v = v.astype(np.float32)
        if k == "attention_maps" and ablate_attention:
            v = np.zeros_like(v)
        host = torch.as_tensor(v)
        out[k] = host.pin_memory().to(device, non_blocking=True) if pin \
            else host.to(device)
    return out


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, the gradient clip and the
    optimizer step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    clip: float = 0.0
    step: int = 0

    @classmethod
    def create(cls, model, args, steps_sup: int, steps_rl: int,
               step: int = 0, device="cuda",
               opt_state: dict | None = None) -> "TrainState":
        """The state of ``model``, moved to ``device`` (the card unless
        the caller asks for the CPU), with ``schedule.make_optimizer``'s
        Adam and schedule from the flags, starting at optimizer step
        ``step`` (with the moments of ``opt_state`` when resuming)."""
        model.to(device)
        opt, sched = make_optimizer(model.parameters(), args, steps_sup,
                                    steps_rl, step, opt_state)
        return cls(model, opt, sched, args.clip, step)

    def apply_gradients(self) -> torch.Tensor:
        """Sum the gradients over the ranks, clip them by their global
        norm (when ``clip`` > 0), step Adam and the schedule, count the
        step.  A parameter the loss did not reach gets a zero gradient
        (before the sum, so every rank reduces the same tensors), so it
        still decays and its moments move, as under optax.  Returns the
        global norm before the clip."""
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.reduce_gradients(params)
        norm = self.clip_gradients(params)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return norm.detach()

    def clip_gradients(self, params) -> torch.Tensor:
        """Clips the gradients of ``params`` by their global norm (when
        ``clip`` > 0); returns the norm."""
        return torch.nn.utils.clip_grad_norm_(
            params, self.clip if self.clip > 0 else math.inf)


def _model_inputs(task: str, batch: dict) -> dict:
    kw = {}
    if task in ("air", "coco"):
        kw["attention_maps"] = batch["attention_maps"]
    if task == "coco":
        kw["task_ids"] = batch["tasks"]
    return kw


def _scalars(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Supervised step
# ---------------------------------------------------------------------------

def supervised_loss(model, batch: dict, lambda_1: float):
    """(loss, metrics) of a supervised batch: the soft-target cross
    entropy of the action logits plus ``lambda_1`` times the LogNormal
    NLL of the durations.  Runs the training forward, which updates the
    BN running statistics."""
    kw = _model_inputs(model.task, batch)
    if model.task == "air":
        kw["performances"] = batch["performances"]
    out = model.forward_train(batch["images"], train=True, **kw)
    logits = out["actions"] if model.task != "air" \
        else out["all_actions_prob"]
    loss_actions = losses.cross_entropy_loss(
        logits, batch["scanpaths"], batch["action_masks"])
    loss_duration = losses.mlp_log_normal_distribution(
        out["log_normal_mu"], out["log_normal_sigma2"], batch["durations"],
        batch["duration_masks"])
    loss = loss_actions + lambda_1 * loss_duration
    # each term is this rank's share of the global one
    return loss, _scalars({"loss": mesh.global_sum(loss),
                           "loss_actions": mesh.global_sum(loss_actions),
                           "loss_duration": mesh.global_sum(loss_duration)})


def supervised_step(state: TrainState, batch: dict, lambda_1: float) -> dict:
    """One supervised update of ``state`` (in place).  Returns the
    metrics: ``loss``, ``loss_actions``, ``loss_duration`` and the
    global gradient norm before the clip, ``grad_norm``."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = supervised_loss(state.model, batch, lambda_1)
    loss.backward()
    metrics["grad_norm"] = state.apply_gradients()
    return metrics


# ---------------------------------------------------------------------------
# SCST
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RLConfig:
    task: str
    grid: GridSpec
    rl_sample_number: int
    # Static bounds of the NW tables, from the training split
    # (EvaluationDataset.wd_symbols_needed / .pad_gt_len) so that no GT
    # overflows; a sampled rollout can still pass max_symbols_wd
    # (durations are unbounded LogNormals), which is counted and reported
    # as reward_overflow_frac.
    max_symbols_wd: int = 256
    max_symbols_wod: int = 24
    apply_cd: bool = False
    lambda_5: float = -2.0

    @property
    def spec_wd(self) -> tm.ScanMatchSpec:
        return tm.ScanMatchSpec(xres=self.grid.width, yres=self.grid.height,
                                temp_bin=50.0,
                                max_symbols=self.max_symbols_wd)

    @property
    def spec_wod(self) -> tm.ScanMatchSpec:
        return tm.ScanMatchSpec(
            xres=self.grid.width, yres=self.grid.height, temp_bin=0.0,
            max_symbols=max(self.grid.max_length, self.max_symbols_wod))


def _hmean2(a, b):
    ok = (a > 0) & (b > 0)
    return torch.where(ok, 2.0 * a * b / torch.where(ok, a + b, 1.0), 0.0)


@torch.no_grad()
def _pair_grids(cfg: RLConfig, gt_fix, gt_len, gt_mask, pred_fix, pred_len,
                full: bool = False) -> dict:
    """Per-(rollout, sample, subject) metric grids of R rollouts, without
    gradients: always {"wod", "wd"} [R, N, S] (two NW launches over
    R*N*S pairs); with ``full`` also MultiMatch {"mm"} [R, N, S, 5],
    {"sed"} and {"stde"} [R, N, S], the reference's whole ``pairs_eval``
    column set (OSIE/utils/evaluation.py:284-340)."""
    r, n = pred_fix.shape[:2]
    s = gt_fix.shape[1]
    rest = gt_fix.shape[2:]
    gt_fix_r = gt_fix.expand(r, *gt_fix.shape)
    gt_len_r = gt_len.expand(r, *gt_len.shape)
    pred_fix = pred_fix.reshape(r * n, *pred_fix.shape[2:])
    pred_len = pred_len.reshape(r * n)
    wod, wd = tm.scanmatch_pair_grid(
        cfg.spec_wd, cfg.spec_wod, gt_fix_r.reshape(r * n, s, *rest),
        gt_len_r.reshape(r * n, s),
        gt_mask.expand(r, *gt_mask.shape).reshape(r * n, s), pred_fix,
        pred_len)
    out = {"wod": wod.reshape(r, n, s), "wd": wd.reshape(r, n, s)}
    if not full:
        return out
    gt_flat = gt_fix_r.reshape(r * n * s, *rest)
    gt_len_flat = gt_len_r.reshape(r * n * s)
    pred_rep = torch.repeat_interleave(pred_fix, s, dim=0)
    pred_len_rep = torch.repeat_interleave(pred_len, s, dim=0)
    g = cfg.grid
    out["mm"] = tm.multimatch_scores(
        gt_flat, gt_len_flat, pred_rep, pred_len_rep, xres=g.width,
        yres=g.height).reshape(r, n, s, 5)
    out["sed"] = tm.sed_scores(
        gt_flat, gt_len_flat, pred_rep, pred_len_rep, height=g.height,
        width=g.width).float().reshape(r, n, s)
    out["stde"] = tm.stde_scores(
        gt_flat, gt_len_flat, pred_rep, pred_len_rep, height=g.height,
        width=g.width).reshape(r, n, s)
    return out


def _eval_forward(model, batch: dict) -> dict:
    """The SCST forward: eval mode (softmaxed, frozen BN), with
    gradients."""
    return model.forward_train(batch["images"], train=False,
                               **_model_inputs(model.task, batch))


def _rollouts(cfg: RLConfig, probs, mu, sigma2, generator, noise):
    """``cfg.rl_sample_number`` scanpaths per sample from one stream's
    distributions, every leaf leading with [R]: from ``noise`` (Gumbel
    [R, N, T, A], normal [R, N, T], N the global batch) when given, else
    drawn from ``generator`` for the global batch; this rank's rows of
    it."""
    if noise is None:
        noise = sample_noise(probs, mu, generator, cfg.rl_sample_number,
                             batch=probs.shape[0] * mesh.data_size())
    return random_sample_from_noise(
        probs, mu, sigma2, cfg.grid, *(mesh.slice_rows(z, 1) for z in noise))


def _reinforce_terms(samples, mu, sigma2):
    """Per-rollout negative REINFORCE log-probabilities [R, N] of the
    actions and the durations (each rollout normalised by its own global
    mask sum)."""
    nla = torch.stack([-losses.log_action(p, m) for p, m in
                       zip(samples.action_probs, samples.action_mask)])
    nld = torch.stack([-losses.log_duration(d, mu, sigma2, m) for d, m in
                       zip(samples.durations, samples.duration_mask)])
    return nla, nld


def rl_loss(model, batch: dict, cfg: RLConfig,
            generator: torch.Generator | None = None, noise=None):
    """(loss, metrics) of one SCST batch at the current parameters.
    ``noise`` (for tests and replays): one (Gumbel, normal) pair per
    stream (AiR: good, then poor), each leading with [R], for the global
    batch; else the rollouts are drawn from ``generator``."""
    out = _eval_forward(model, batch)
    if model.task == "air":
        return _air_rl_loss(out, batch, cfg, generator, noise)
    probs = out["all_actions_prob"]
    mu = out["log_normal_mu"]
    sigma2 = out["log_normal_sigma2"]
    samples = _rollouts(cfg, probs, mu, sigma2, generator,
                        noise[0] if noise else None)

    full = cfg.task == "osie"
    grids = _pair_grids(cfg, batch["gt_fix"], batch["gt_len"],
                        batch["gt_mask"], samples.fix.detach(),
                        samples.fix_len, full=full)
    wod, wd = grids["wod"], grids["wd"]
    gt_mask = batch["gt_mask"][None]                          # [1, N, S]
    if full:
        # the reference's pairs_eval row voiding: a (GT, rollout) pair
        # is dropped when ANY MultiMatch similarity is NaN
        # (OSIE/utils/evaluation.py:296-299,327)
        pair_ok = (gt_mask > 0) & ~torch.isnan(grids["mm"]).any(-1)
    else:
        pair_ok = (gt_mask > 0) & ~torch.isnan(wod) & ~torch.isnan(wd)
    pair_okf = pair_ok.float()
    total = batch["gt_mask"].sum(-1)[None].clamp_min(1.0)     # [1, N]

    def grid_mean(x):
        return torch.where(torch.isnan(x), 0.0, x * pair_okf).sum(-1) / total

    wod_mean = grid_mean(wod)
    wd_mean = grid_mean(wd)
    reward = _hmean2(wod_mean, wd_mean)                       # [R, N]
    ok = pair_ok.any(-1).float()                              # [R, N]
    baseline = (reward * ok).sum(0) / ok.sum(0).clamp_min(1.0)
    adv = (reward - baseline[None]) * ok

    nla, nld = _reinforce_terms(samples, mu, sigma2)
    loss = (nla * adv).sum() + (nld * adv).sum()
    # the rollouts whose TempBin expansion passes the NW table's bound
    overflow = tm.expansion_overflow(
        cfg.spec_wd, samples.fix.detach().flatten(0, 1),
        samples.fix_len.flatten(0, 1))
    metrics = {"rl_loss": mesh.global_sum(loss),
               "reward_hmean": mesh.global_mean(reward),
               "rollout_ok_frac": mesh.global_mean(ok),
               "reward_overflow_frac": mesh.global_mean(overflow.float())}
    if full:
        # the reference's 11 metrics_for_reward/* scalars
        # (OSIE/train.py:269-281): the pairs_eval columns averaged over
        # the valid (rollout, sample) entries
        denom = mesh.global_sum(ok.sum()).clamp_min(1.0)

        def col_mean(per_rn):
            return mesh.global_sum((per_rn * ok).sum()) / denom

        mm_mean = grid_mean(grids["mm"].movedim(-1, 0))       # [5, R, N]
        big = 3.4e38
        sed_best = torch.where(pair_ok, grids["sed"], big).amin(-1)
        stde_best = torch.where(pair_ok, grids["stde"], -big).amax(-1)
        for i, name in enumerate(MULTIMATCH_NAMES):
            metrics[f"metrics_for_reward/{name}"] = col_mean(mm_mean[i])
        metrics["metrics_for_reward/w/o duration"] = col_mean(wod_mean)
        metrics["metrics_for_reward/w/ duration"] = col_mean(wd_mean)
        metrics["metrics_for_reward/SED mean"] = col_mean(
            grid_mean(grids["sed"]))
        metrics["metrics_for_reward/STDE mean"] = col_mean(
            grid_mean(grids["stde"]))
        metrics["metrics_for_reward/SED best"] = col_mean(sed_best)
        metrics["metrics_for_reward/STDE best"] = col_mean(stde_best)
    else:
        metrics["reward_wod"] = mesh.global_mean(wod_mean)
        metrics["reward_wd"] = mesh.global_mean(wd_mean)
    return loss, _scalars(metrics)


def _air_rl_loss(out, batch, cfg: RLConfig, generator, noise):
    """AiR SCST: R rollouts per stream (good first, reference
    AiR/train.py:225), same- and different-answer group rewards,
    per-stream baselines."""
    r = cfg.rl_sample_number
    perf = batch["gt_performance"]                            # [N, S]
    gt_mask = batch["gt_mask"]

    rewards, terms = [], []
    for si, stream in enumerate(("good", "poor")):
        probs = out[f"{stream}_all_actions_prob"]
        mu = out[f"{stream}_log_normal_mu"]
        sigma2 = out[f"{stream}_log_normal_sigma2"]
        samples = _rollouts(cfg, probs, mu, sigma2, generator,
                            noise[si] if noise else None)
        grids = _pair_grids(cfg, batch["gt_fix"], batch["gt_len"], gt_mask,
                            samples.fix.detach(), samples.fix_len)
        wod, wd = grids["wod"], grids["wd"]
        flag = float(stream == "good")
        same = (perf[None] == flag) & (gt_mask[None] > 0)
        diff = (perf[None] != flag) & (gt_mask[None] > 0)

        def group_reward(sel):
            okp = sel & ~torch.isnan(wod) & ~torch.isnan(wd)
            cnt = okp.sum(-1).clamp_min(1)
            wodm = torch.where(okp, wod, 0.0).sum(-1) / cnt
            wdm = torch.where(okp, wd, 0.0).sum(-1) / cnt
            # an empty group: the reference's NaN, zeroed (AiR/train.py:282)
            return torch.where(okp.any(-1), _hmean2(wodm, wdm), 0.0)

        rewards.append((group_reward(same), group_reward(diff)))
        terms.append(_reinforce_terms(samples, mu, sigma2))

    same_r = torch.cat([rewards[0][0], rewards[1][0]])        # [2R, N]
    diff_r = torch.cat([rewards[0][1], rewards[1][1]])
    nla = torch.cat([terms[0][0], terms[1][0]])
    nld = torch.cat([terms[0][1], terms[1][1]])

    def stream_baseline(x):
        return x.reshape(2, r, -1).mean(1, keepdim=True) \
            .expand(2, r, x.shape[-1]).reshape(2 * r, -1)

    adv = same_r - stream_baseline(same_r)
    loss = (nla * adv).sum() + (nld * adv).sum()
    if cfg.apply_cd:
        # the Consistency-Divergence term (the paper's; the reference
        # computes it at AiR/train.py:309-330 but never adds it)
        cd = ((same_r - diff_r) - _gtpairs_cd_target(batch, cfg)).abs()
        cd_adv = cd - stream_baseline(cd)
        loss = loss + cfg.lambda_5 * ((nla * cd_adv).sum()
                                      + (nld * cd_adv).sum())
    return loss, _scalars({"rl_loss": mesh.global_sum(loss),
                           "reward_same_hmean": mesh.global_mean(same_r),
                           "reward_diff_hmean": mesh.global_mean(diff_r)})


@torch.no_grad()
def _gtpairs_cd_target(batch, cfg: RLConfig):
    """The GT-against-GT (same - different) score gap of each sample,
    replicated to the [2R, N] rollout grid, zero where either group
    score is zero (reference AiR/train.py:310-328)."""
    r = cfg.rl_sample_number
    gt_fix, gt_len, gt_mask = (batch["gt_fix"], batch["gt_len"],
                               batch["gt_mask"])
    perf = batch["gt_performance"]
    n, s = gt_mask.shape
    rest = gt_fix.shape[2:]

    # every (i, j) subject pair of every sample
    fix_i = torch.repeat_interleave(gt_fix, s, dim=1).reshape(n * s * s,
                                                              *rest)
    len_i = torch.repeat_interleave(gt_len, s, dim=1).reshape(n * s * s)
    fix_j = gt_fix.repeat(1, s, 1, 1).reshape(n * s * s, *rest)
    len_j = gt_len.repeat(1, s).reshape(n * s * s)
    wd = tm.scanmatch_scores(cfg.spec_wd, fix_i, len_i, fix_j,
                             len_j).reshape(n, s, s)
    wod = tm.scanmatch_scores(cfg.spec_wod, fix_i, len_i, fix_j,
                              len_j).reshape(n, s, s)

    real = gt_mask > 0
    valid = real[:, :, None] & real[:, None, :]
    upper = torch.triu(torch.ones((s, s), dtype=torch.bool,
                                  device=gt_mask.device), diagonal=1)[None]
    good = perf > 0.5

    def group(mask):
        m = (mask & valid & ~torch.isnan(wd) & ~torch.isnan(wod)).flatten(1)
        cnt = m.sum(1).clamp_min(1)
        wodm = torch.where(m, wod.flatten(1), 0.0).sum(1) / cnt
        wdm = torch.where(m, wd.flatten(1), 0.0).sum(1) / cnt
        return torch.where(m.any(1), _hmean2(wodm, wdm), 0.0)

    gg = group(good[:, :, None] & good[:, None, :] & upper)
    pp = group(~good[:, :, None] & ~good[:, None, :] & upper & valid)
    gp = group(good[:, :, None] & ~good[:, None, :])
    same = torch.cat([gg.repeat(r), pp.repeat(r)]).reshape(2 * r, n)
    diff = gp.repeat(2 * r).reshape(2 * r, n)
    usable = ((same != 0) & (diff != 0)).float()
    return (same - diff) * usable


def rl_step(state: TrainState, batch: dict, cfg: RLConfig,
            generator: torch.Generator | None = None, noise=None) -> dict:
    """One SCST update of ``state`` (in place); the arguments of
    :func:`rl_loss`.  Returns its metrics and ``grad_norm``, the global
    gradient norm before the clip.  BN's running statistics do not
    move (the forward is in eval mode)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = rl_loss(state.model, batch, cfg, generator, noise)
    loss.backward()
    metrics["grad_norm"] = state.apply_gradients()
    return metrics
