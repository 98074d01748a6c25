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

``--bf16_moments`` swaps torch Adam for :class:`Adam`, the port's own,
which stores the first moment in bfloat16 as optax's
``scale_by_adam(mu_dtype=bfloat16)`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def lr_multiplier(iteration: int, steps_sup: int, steps_rl: int,
                  warmup_epoch: int, start_rl_epoch: int, epochs: int,
                  rl_lr_initial_decay: float) -> float:
    """The reference lr_lambda at the (0-based optimizer) step count, in
    float32 arithmetic as the JAX package computes it, so the trainer's
    ``learning_rate`` scalar equals the JAX trainer's bit for bit."""
    f = np.float32
    it = f(iteration)
    warm_end = steps_sup * warmup_epoch
    sup_end = steps_sup * start_rl_epoch
    if iteration <= warm_end:
        return float(it / f(max(warm_end, 1)))
    if iteration <= sup_end:
        return float(f(1.0) - (it - f(warm_end))
                     / f(max(sup_end - warm_end, 1)))
    rl_total = steps_rl * max(epochs - start_rl_epoch, 1)
    return float(f(rl_lr_initial_decay)
                 * (f(1.0) - (it - f(sup_end)) / f(rl_total)))


def _f32_lr(group: dict) -> float:
    """The group's lr as optax's schedule forms it: the float32 product
    of the flag's lr and the float32 multiplier (LambdaLR holds their
    product in float64)."""
    base = group.get("initial_lr")
    if not base:
        return group["lr"]
    return float(np.float32(base) * np.float32(group["lr"] / base))


class Adam(torch.optim.Optimizer):
    """Adam with L2 ``weight_decay`` whose first moment is stored in
    ``mu_dtype``: optax 0.2.6's ``add_decayed_weights`` then
    ``scale_by_adam(mu_dtype=...)`` then the learning rate, op for op.

    * The moment update is optax's ``(1 - b1) * g + b1 * mu``: with
      ``mu`` stored in bfloat16, ``b1 * mu`` is a bfloat16 product (the
      Python float ``b1`` takes ``mu``'s dtype, 0.9 -> 0.8984375, and
      the product is rounded to bfloat16), added to the float32
      ``(1 - b1) * g``; the sum is float32.
    * The update divides that float32 moment, bias-corrected, by
      ``sqrt(nu_hat) + eps``; only the stored moment is rounded to
      ``mu_dtype`` (round to nearest even, as optax's cast).  The second
      moment stays float32.

    This is the update as optax writes it, which an op-by-op JAX run
    computes; XLA's jit may keep ``b1 * mu`` in float32 (its default
    ``xla_allow_excess_precision``), which moves some stored moments by
    one bfloat16 ulp.  The state has torch Adam's keys (``step``,
    ``exp_avg``, ``exp_avg_sq``), so ``make_optimizer``'s resume rules
    and the trainer's ``adam_step`` apply unchanged; a loaded state keeps
    its ``exp_avg`` in ``mu_dtype``."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, mu_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    def load_state_dict(self, state_dict):
        # Optimizer.load_state_dict casts every moment to its parameter's
        # dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)

    def _state(self, p):
        st = self.state[p]
        if not st:
            st["step"] = torch.tensor(0.0)
            st["exp_avg"] = torch.zeros_like(
                p, dtype=self.mu_dtype, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self._state(p) for p in params]
            grads = [p.grad for p in params]
            mu = [st["exp_avg"] for st in states]
            nu = [st["exp_avg_sq"] for st in states]
            # g = g + wd * p, two roundings as optax's (g is this step's
            # own buffer: it becomes the update)
            if group["weight_decay"]:
                g = torch._foreach_mul(params, group["weight_decay"])
                torch._foreach_add_(g, grads)
            else:
                g = torch._foreach_mul(grads, 1.0)
            # nu = b2 * nu + (1 - b2) * g * g
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            # m = (1 - b1) * g + b1 * mu, the product in mu's dtype (sq,
            # free again, takes it to float32); mu = m rounded
            torch._foreach_mul_(g, 1 - b1)
            torch._foreach_mul_(mu, float(torch.tensor(b1,
                                                       dtype=self.mu_dtype)))
            torch._foreach_copy_(sq, mu)
            torch._foreach_add_(g, sq)
            torch._foreach_copy_(mu, g)
            # optax's count and bias corrections, in float32:
            # p += -lr * (m / bc1) / (sqrt(nu / bc2) + eps)
            torch._foreach_add_([st["step"] for st in states], 1)
            count = np.float32(states[0]["step"].item())
            torch._foreach_copy_(sq, nu)
            torch._foreach_div_(sq, float(1 - np.float32(b2) ** count))
            torch._foreach_sqrt_(sq)
            torch._foreach_add_(sq, group["eps"])
            torch._foreach_div_(g, float(1 - np.float32(b1) ** count))
            torch._foreach_div_(g, sq)
            torch._foreach_mul_(g, -_f32_lr(group))
            torch._foreach_add_(params, g)
        return loss


def make_optimizer(params, args, steps_sup: int, steps_rl: int,
                   step: int = 0, opt_state: dict | None = None):
    """(Adam, LambdaLR) over ``params`` from the flags (``lr``,
    ``weight_decay``, ``warmup_epoch``, ``start_rl_epoch``, ``epoch``,
    ``rl_lr_initial_decay``; torch Adam, or with ``bf16_moments`` the
    port's :class:`Adam` with a bfloat16 first moment), the schedule
    starting at optimizer step
    ``step``.  ``opt_state``, a saved Adam ``state_dict`` (a resume),
    gives the moments and step counts only: the hyperparameters and the
    lr are the flags' own, as the JAX trainer rebuilds its schedule from
    the flags, so a resume with another ``--epoch`` applies the new
    schedule from its first step.  The clip (``args.clip``) is applied by
    the caller before each step (``steps.TrainState.apply_gradients``)."""
    params = list(params)
    kw = dict(lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=args.weight_decay or 0.0)
    opt = (Adam(params, mu_dtype=torch.bfloat16, **kw)
           if getattr(args, "bf16_moments", False)
           else torch.optim.Adam(params, **kw))
    if opt_state is not None:
        # the saved param_groups hold the lr of the saved run's schedule;
        # keep this optimizer's groups and take the state alone, before
        # the LambdaLR sets each group's lr from the flags
        opt.load_state_dict({"state": opt_state["state"],
                             "param_groups": opt.state_dict()["param_groups"]})
    elif step:
        # Adam's bias correction counts from the same step (optax keeps
        # one count for the moments and the schedule)
        for p in params:
            opt.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": torch.zeros_like(
                    p, dtype=getattr(opt, "mu_dtype", None),
                    memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}

    def schedule(i):
        return lr_multiplier(i + step, steps_sup, steps_rl,
                             args.warmup_epoch, args.start_rl_epoch,
                             args.epoch, args.rl_lr_initial_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
