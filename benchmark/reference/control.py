"""The control of the output check: the reference put in the program's
place and computed in the nearest precision below the configuration's.
The configurations run in float32 with TF32 off, so the control runs the
reference with TF32 on in cuDNN and cuBLAS, and decodes its own
distributions by the same rules and noise.  The check has to find it
not correct."""

from __future__ import annotations

import contextlib

import torch

from . import model, sampler


@contextlib.contextmanager
def tf32():
    """TF32 on in cuBLAS and cuDNN inside, as it was after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


@torch.no_grad()
def served(sd, cfg, images, attention_maps, noises=None,
           precision: str = "tf32"):
    """What the control serves for a batch: one dict per stream in the
    program's terms (``probs``, ``mu``, ``sigma2``, ``actions``,
    ``durations``, ``fix``, ``fix_len``).  ``noises``: one (gumbel,
    normal) pair per stream for a sampled decode, None for greedy.
    ``precision``: ``tf32`` (the configurations' control, on the card),
    or ``bfloat16`` (weights and inputs cast; the CPU has no TF32)."""
    if precision == "bfloat16":
        sd = {k: v.bfloat16() for k, v in sd.items()}
        images = images.bfloat16()
        outs = model.forward(sd, cfg, images, attention_maps)
    else:
        with tf32():
            outs = model.forward(sd, cfg, images, attention_maps)
    result = []
    for si, out in enumerate(outs):
        if noises is None:
            dec = sampler.greedy(out["logits"], out["mu"], cfg)
        else:
            dec = sampler.sample(out["logits"], out["mu"], out["sigma2"],
                                 *noises[si], cfg)
        actions, durations, fix, lengths = dec
        result.append({"probs": torch.softmax(out["logits"], dim=-1),
                       "mu": out["mu"], "sigma2": out["sigma2"],
                       "actions": actions, "durations": durations,
                       "fix": fix, "fix_len": lengths})
    return result
