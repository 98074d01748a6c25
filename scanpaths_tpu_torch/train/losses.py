"""Loss functions and saliency measures (port of
``scanpaths_tpu/train/losses.py``), with the reference's normalisation
quirks kept:

* every mask-normalised loss divides by the GLOBAL mask sum over the
  whole batch (reference loss.py:13,31,36,44), not per-sample counts;
  under data parallel that sum is over every rank's rows
  (``mesh.global_sum``), so each rank's loss is its share of the global
  one and the ranks' gradients add up to the global gradient;
* the cross entropy applies its own softmax to raw logits (loss.py:12).
"""

from __future__ import annotations

import math

import torch

from .mesh import global_sum

EPSILON = 1e-7


def cross_entropy_loss(logits, gt, mask):
    """Soft-target CE.  logits [N,T,A] raw, gt [N,T,A], mask [N,T]."""
    p = torch.softmax(logits, dim=-1)
    return -(gt * torch.log(p + EPSILON) * mask[..., None]).sum() \
        / global_sum(mask.sum())


def duration_smooth_l1_loss(pred, gt, mask):
    """Reference DurationSmoothL1Loss (loss.py:16-19): huber(beta=1) on
    mask-multiplied values, summed, over the global mask sum."""
    x = pred * mask - gt * mask
    ax = x.abs()
    huber = torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)
    return huber.sum() / global_sum(mask.sum())


def _log_normal_logpdf(x, mu, sigma2):
    return torch.log(1.0 / (x + EPSILON) / torch.sqrt(2 * math.pi * sigma2)) \
        + (-(torch.log(x + EPSILON) - mu) ** 2 / (2 * sigma2))


def mlp_log_normal_distribution(mu, sigma2, gt, mask):
    """LogNormal NLL of ground-truth durations (loss.py:27-32)."""
    return -(_log_normal_logpdf(gt, mu, sigma2) * mask).sum() \
        / global_sum(mask.sum())


def mlp_rayleigh_distribution(sigma2, gt, mask):
    """Rayleigh duration NLL (loss.py:21-25; parsed but unused by the
    reference drivers)."""
    logpdf = torch.log(gt / sigma2 + EPSILON) + (-(gt ** 2) / (2 * sigma2))
    return -(logpdf * mask).sum() / global_sum(mask.sum())


def log_action(selected_probs, mask):
    """Per-sample REINFORCE action log-prob over the global mask sum
    (loss.py:34-37).  [N, T] -> [N]."""
    return (torch.log(selected_probs + EPSILON) * mask).sum(-1) \
        / global_sum(mask.sum())


def log_duration(durations, mu, sigma2, mask):
    """Per-sample REINFORCE duration log-prob (loss.py:39-45).  [N]."""
    return (_log_normal_logpdf(durations, mu, sigma2) * mask).sum(-1) \
        / global_sum(mask.sum())


# -- saliency measures (imported by the reference drivers; they do not
#    enter the training losses) --------------------------------------------

def _flat_unit_sum(saliency, salmap):
    a = saliency.reshape(saliency.shape[0], -1)
    b = salmap.reshape(salmap.shape[0], -1)
    return (a / (a.sum(-1, keepdim=True) + EPSILON),
            b / (b.sum(-1, keepdim=True) + EPSILON))


def nss(saliency, fixation):
    s = saliency.reshape(saliency.shape[0], -1)
    f = fixation.reshape(fixation.shape[0], -1)
    s = s / (s.amax(-1, keepdim=True) + EPSILON)
    # torch .std() is unbiased (ddof=1), as the reference's (loss.py:52)
    s = (s - s.mean(-1, keepdim=True)) / (s.std(-1, keepdim=True) + EPSILON)
    return ((s * f).sum(-1) / (f.sum(-1) + EPSILON)).mean()


def _per_sample_cc(saliency, salmap):
    a, b = _flat_unit_sum(saliency, salmap)
    a = a - a.mean(-1, keepdim=True)
    b = b - b.mean(-1, keepdim=True)
    cov = (a * b).sum(-1)
    return cov / (torch.sqrt((a ** 2).sum(-1)) * torch.sqrt((b ** 2).sum(-1))
                  + EPSILON)


def cc(saliency, salmap):
    return _per_sample_cc(saliency, salmap).mean()


def kld_items(saliency, salmap):
    """Per-sample (un-meaned) KLD (reference ``KLD_items``,
    AiR/models/loss.py:116-126)."""
    a, b = _flat_unit_sum(saliency, salmap)
    return (b * torch.log(b / (a + EPSILON) + EPSILON)).sum(-1)


def kld(saliency, salmap):
    return kld_items(saliency, salmap).mean()


# -- AiR paper-ablation extras (reference AiR/models/loss.py:75-171;
#    imported by AiR/train.py:21-23 but never called).  The reference's
#    data-dependent indexing and loops are masked fixed-shape forms, as in
#    the JAX package. ----------------------------------------------------------

def cc_terms(saliency, salmap, good_duration_masks, poor_duration_masks):
    """Per-sample CC where BOTH the good and poor streams produced
    fixations (reference ``CC_terms``, loss.py:75-103).  Returns (cc [N],
    paired_mask [N]); the mask says which entries the reference's ragged
    vector would hold."""
    paired = ((good_duration_masks.sum(-1) > 0)
              & (poor_duration_masks.sum(-1) > 0)).float()
    return _per_sample_cc(saliency, salmap) * paired, paired


def cc_match_loss(gt_cc, pre_cc):
    """Mean absolute CC gap (reference ``CC_MatchLoss``, loss.py:104-106)."""
    return (gt_cc - pre_cc).abs().mean()


def kld_visual_linguistic_alignment(saliency, question_objects_pos,
                                    question_objects_masks,
                                    fullanswer_objects_pos,
                                    fullanswer_objects_masks):
    """KLD between the softmaxed saliency map and the binarised union of
    the question and full-answer object regions (reference
    ``KLD_visual_linguistic_alignment``, loss.py:128-139).

    saliency: [N, H, W]; *_objects_pos: [N, H, W, K]; *_masks: [N, K].
    """
    n, h, w = saliency.shape[:3]
    gt = (question_objects_pos
          * question_objects_masks[:, None, None, :]).sum(-1) \
        + (fullanswer_objects_pos
           * fullanswer_objects_masks[:, None, None, :]).sum(-1)
    gt = (gt > 0).float()
    gt = gt / (gt.reshape(n, -1).sum(-1)[:, None, None] + EPSILON)
    sal = torch.softmax(saliency.reshape(n, -1), -1).reshape(n, h, w)
    return kld(sal, gt)


def kld_question_aligment(saliency, question_objects_pos,
                          question_objects_masks, duration_masks):
    """For every (sample, question object): the minimum over valid time
    steps of KLD(softmaxed step map || object map); the mean over valid
    pairs (reference ``KLD_question_aligment``, loss.py:141-171, as a
    fixed-shape [N, T, K] grid reduction).

    saliency: [N, T, H, W]; question_objects_pos: [N, H, W, K];
    question_objects_masks: [N, K]; duration_masks: [N, T].
    """
    n, t = saliency.shape[:2]
    k = question_objects_pos.shape[-1]
    sal = torch.softmax(saliency.reshape(n * t, -1), -1).reshape(n, t, -1)
    obj = question_objects_pos.reshape(n, -1, k).transpose(1, 2)  # [N,K,HW]
    obj_n = obj / (obj.sum(-1, keepdim=True) + EPSILON)
    # kl[n, t, k] = sum_hw obj_n * log(obj_n / sal + eps)
    kl = torch.einsum("nkh,ntkh->ntk", obj_n,
                      torch.log(obj_n[:, None] / (sal[:, :, None] + EPSILON)
                                + EPSILON))
    kl = torch.where(duration_masks[..., None] > 0, kl, torch.inf)
    min_kl = kl.amin(dim=1)                                   # [N, K]
    m = question_objects_masks
    return torch.where(m > 0, min_kl, 0.0).sum() / m.sum().clamp_min(1.0)
