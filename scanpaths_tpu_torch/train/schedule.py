"""Learning-rate schedule and optimizer (port of
``scanpaths_tpu/train/schedule.py``).

The schedule multiplier follows the reference LambdaLR (reference
OSIE/train.py:150-161): a linear warmup over ``warmup_epoch`` supervised
epochs, a linear decay to zero until ``start_rl_epoch``, then a step
down by ``rl_lr_initial_decay`` and a linear decay over the RL epochs
(in RL-loader steps).

The optimizer is the reference's (OSIE/train.py:111-112, 185-187) and
the JAX package's optax chain: the gradients clipped by their global
norm first (``clip_grad_norm_`` before the step), then torch Adam with
L2 ``weight_decay`` (``wd * param`` added to the gradient before the
moments, as ``optax.add_decayed_weights`` ahead of ``scale_by_adam``),
betas (0.9, 0.999), eps 1e-8, and a ``LambdaLR`` of
:func:`lr_multiplier`.  One difference in the clip: optax scales by
``clip / max(norm, clip)``, torch by ``clip / (norm + 1e-6)`` (capped at
1), so a clipped gradient differs by a factor of at most
``1 + 1e-6 / norm`` (under 1e-7 relative at the default clip of 12.5).
"""

from __future__ import annotations

import torch


def lr_multiplier(iteration: int, steps_sup: int, steps_rl: int,
                  warmup_epoch: int, start_rl_epoch: int, epochs: int,
                  rl_lr_initial_decay: float) -> float:
    """The reference lr_lambda at the (0-based optimizer) step count."""
    warm_end = steps_sup * warmup_epoch
    sup_end = steps_sup * start_rl_epoch
    if iteration <= warm_end:
        return iteration / max(warm_end, 1)
    if iteration <= sup_end:
        return 1.0 - (iteration - warm_end) / max(sup_end - warm_end, 1)
    rl_total = steps_rl * max(epochs - start_rl_epoch, 1)
    return rl_lr_initial_decay * (1.0 - (iteration - sup_end) / rl_total)


def make_optimizer(params, args, steps_sup: int, steps_rl: int,
                   step: int = 0):
    """(torch Adam, LambdaLR) over ``params`` from the flags (``lr``,
    ``weight_decay``, ``warmup_epoch``, ``start_rl_epoch``, ``epoch``,
    ``rl_lr_initial_decay``), the schedule starting at optimizer step
    ``step``.  The clip (``args.clip``) is applied by the caller before
    each step (``steps.TrainState.apply_gradients``)."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=args.weight_decay or 0.0)
    if step:
        # Adam's bias correction counts from the same step (optax keeps
        # one count for the moments and the schedule)
        for p in params:
            opt.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}

    def schedule(i):
        return lr_multiplier(i + step, steps_sup, steps_rl,
                             args.warmup_epoch, args.start_rl_epoch,
                             args.epoch, args.rl_lr_initial_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
