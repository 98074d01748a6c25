"""Device-side full-suite evaluation sweep, ``--device_eval`` (port of
``scanpaths_tpu/metrics/device_eval.py``).

Every pairwise metric row comes from the device metrics
(``metrics/torch_metrics.py``, the ScanMatch alignment through the
``ops/nw.py`` kernel); the host keeps only the reference's cheap
aggregation (NaN handling, per-image best groups, bucketing) by reusing
the host suite's own ``_summarize``/``_bucketize``, so the output tree
is the host suite's.

Row layout matches ``evaluation.pair_metrics``: [mm_vector,
mm_direction, mm_length, mm_position, mm_duration, sm_wod, sm_wd, sed,
stde].
"""

from __future__ import annotations

import numpy as np
import torch

from . import torch_metrics as tm
from .evaluation import _bucketize, _summarize


def _pair_metrics(spec_wd: tm.ScanMatchSpec, spec_wod: tm.ScanMatchSpec,
                  fix_a, len_a, fix_b, len_b):
    """The nine metrics of ``evaluation.pair_metrics(a, b)`` for P flat
    pairs: fix_* [P, L, 3] (durations in seconds), len_* [P] -> [P, 9]
    float32.  Two NW kernel launches (w/o and with duration)."""
    mm = tm.multimatch_scores(fix_a, len_a, fix_b, len_b)
    wod = tm.scanmatch_scores(spec_wod, fix_a, len_a, fix_b, len_b)
    wd = tm.scanmatch_scores(spec_wd, fix_a, len_a, fix_b, len_b)
    sed = tm.sed_scores(fix_a, len_a, fix_b, len_b)
    stde = tm.stde_scores(fix_a, len_a, fix_b, len_b)
    return torch.cat([mm, wod[:, None], wd[:, None], sed[:, None].float(),
                      stde[:, None]], dim=-1).float()


def pair_rows(spec_wd: tm.ScanMatchSpec, spec_wod: tm.ScanMatchSpec,
              gt_fix, gt_len, pred_fix, pred_len):
    """All nine pairwise metrics for every (prediction, GT subject)
    pair, on the device of the tensors.

    gt_fix: [N, S, L, 3] (durations in SECONDS), gt_len: [N, S];
    pred_fix: [N, T, 3], pred_len: [N].  Returns [N, S, 9] float32
    (garbage where the caller's subject mask is 0 — the host
    aggregation filters by mask).
    """
    n, s = gt_fix.shape[:2]
    rows = _pair_metrics(
        spec_wd, spec_wod, gt_fix.reshape(n * s, *gt_fix.shape[2:]),
        gt_len.reshape(n * s), torch.repeat_interleave(pred_fix, s, dim=0),
        torch.repeat_interleave(pred_len, s, dim=0))
    return rows.reshape(n, s, 9)


def human_rows(spec_wd: tm.ScanMatchSpec, spec_wod: tm.ScanMatchSpec,
               gt_fix, gt_len) -> np.ndarray:
    """All ordered subject-vs-subject metric rows for one batch of
    images, as ONE batch of N*S*S pairs: returns [N, S, S, 9] float64
    with ``M[n, a, b] = pair_metrics(subject_a, subject_b)``, subject
    ``a`` on the GT side and ``b`` on the prediction side.  The order
    matters: STDE embeds the FIRST argument's delays and MultiMatch
    aligns a -> b."""
    n, s, length = gt_fix.shape[:3]
    a_fix = gt_fix[:, :, None].expand(n, s, s, length, 3)
    b_fix = gt_fix[:, None, :].expand(n, s, s, length, 3)
    a_len = gt_len[:, :, None].expand(n, s, s)
    b_len = gt_len[:, None, :].expand(n, s, s)
    p = n * s * s
    rows = _pair_metrics(spec_wd, spec_wod, a_fix.reshape(p, length, 3),
                         a_len.reshape(p), b_fix.reshape(p, length, 3),
                         b_len.reshape(p))
    return rows.reshape(n, s, s, 9).double().cpu().numpy()


def _gt_tensors(batch, device):
    return (torch.as_tensor(np.asarray(batch["gt_fix"]), device=device),
            torch.as_tensor(np.asarray(batch["gt_len"]), device=device))


def human_evaluation_device(loader, spec_wd: tm.ScanMatchSpec,
                            spec_wod: tm.ScanMatchSpec, task: str = "osie",
                            device="cuda"):
    """Device human inter-observer baseline — the drop-in replacement
    for ``evaluation.human_evaluation`` under ``--device_eval`` (same
    (metrics, stds, per_image) return tree, aggregation shared with the
    host suite).  Batches are host (numpy) batches; their GT goes to
    ``device``, the card unless the caller asks for the CPU."""
    if task == "air":
        return _human_evaluation_air_device(loader, spec_wd, spec_wod,
                                            device)
    rows, group_sizes = [], []
    per_image = {}
    for batch in loader:
        m = human_rows(spec_wd, spec_wod, *_gt_tensors(batch, device))
        mask = np.asarray(batch["gt_mask"]).astype(bool)
        for bi in range(m.shape[0]):
            ns = int(mask[bi].sum())
            img_scores = []
            for i in range(ns):
                g = 0
                for j in range(ns):
                    if i == j:
                        continue
                    r = m[bi, i, j]
                    rows.append(r)
                    img_scores.append(r)
                    g += 1
                group_sizes.append(g)
            per_image[batch["img_names"][bi]] = list(
                np.asarray(img_scores, np.float64).mean(axis=0))
    metrics, stds = _summarize(np.asarray(rows, np.float64), group_sizes,
                               mm_dropna=False)
    return metrics, stds, per_image


def _human_evaluation_air_device(loader, spec_wd, spec_wod, device):
    """AiR bucketed human baseline on device rows (reference
    AiR/utils/evaluation.py:11-186: NaN pairs skipped entirely, buckets
    by answer-correctness pairs, per-question good/poor means)."""
    rows_by_group = []
    per_qid = {}
    for batch in loader:
        m = human_rows(spec_wd, spec_wod, *_gt_tensors(batch, device))
        mask = np.asarray(batch["gt_mask"]).astype(bool)
        for bi in range(m.shape[0]):
            ns = int(mask[bi].sum())
            performances = list(batch["performances"][bi])
            allr, right, wrong = [], [], []
            for i in range(ns):
                for j in range(ns):
                    if i == j:
                        continue
                    r = m[bi, i, j]
                    if np.any(np.isnan(r)):
                        continue
                    allr.append(r)
                    if performances[i] and performances[j]:
                        right.append(r)
                    elif not performances[i] and not performances[j]:
                        wrong.append(r)
            rows_by_group.append((allr, right, wrong))
            good = list(np.asarray(right, np.float64).mean(0)) if right \
                else [0.0] * 9
            poor = list(np.asarray(wrong, np.float64).mean(0)) if wrong \
                else [0.0] * 9
            per_qid[batch["question_ids"][bi]] = {True: good, False: poor}
    metrics, stds = _bucketize(rows_by_group)
    return metrics, stds, per_qid


class DeviceSweep:
    """Accumulates device-computed pair rows across evaluation batches
    and reproduces ``evaluation(...)``'s aggregation exactly, or, fed by
    :meth:`add_batch_air`, ``evaluation_performance_related(...)``'s."""

    def __init__(self, spec_wd: tm.ScanMatchSpec,
                 spec_wod: tm.ScanMatchSpec):
        self.spec_wd = spec_wd
        self.spec_wod = spec_wod
        self._rows: list[np.ndarray] = []      # one [G, 9] per group
        self._buckets = []                     # air: (all, right, wrong)
        self._overflow = 0                     # truncated rollouts
        self._preds = 0                        # rollouts seen

    @property
    def overflow(self) -> dict:
        """{count, total, frac} of prediction rollouts whose TempBin
        expansion overflowed the w/-duration table (prefix-truncated on
        the device; a nonzero frac means the with-duration ScanMatch
        column may read differently from a host-suite run)."""
        return {"count": self._overflow, "total": self._preds,
                "frac": self._overflow / max(self._preds, 1)}

    def log_overflow(self, logger, writer=None,
                     tag: str = "metrics/wd_overflow_frac", step: int = 0):
        """The truncation counter: a scalar for ``writer`` (if given) and
        a WARNING when any rollout was truncated."""
        ov = self.overflow
        if writer is not None:
            writer.add_scalar(tag, ov["frac"], step)
        if ov["count"]:
            logger.warning(
                f"device-eval w/-duration table overflow: "
                f"{ov['count']}/{ov['total']} rollouts ({ov['frac']:.2%}) "
                f"prefix-truncated — the with-duration ScanMatch column "
                f"may differ from a host-suite run")

    def _compute_rows(self, gt_fix, gt_len, pred_fix, pred_len) -> np.ndarray:
        """Pair rows and the overflow count, read back together in one
        host sync.  Inputs are tensors on one device."""
        rows = pair_rows(self.spec_wd, self.spec_wod, gt_fix, gt_len,
                         pred_fix, pred_len)
        ov = tm.expansion_overflow(self.spec_wd, pred_fix, pred_len).sum()
        out = torch.cat([rows.reshape(-1).double(), ov.double()[None]])
        out = out.cpu().numpy()
        self._overflow += int(out[-1])
        self._preds += int(pred_len.shape[0])
        return out[:-1].reshape(rows.shape)

    def add_batch(self, gt_fix, gt_len, gt_mask, pred_fix, pred_len):
        """One decode repeat of one batch: gt_* [N, S, ...] (mask 1 =
        real subject), pred_* [N, ...]."""
        rows = self._compute_rows(gt_fix, gt_len, pred_fix, pred_len)
        mask = torch.as_tensor(gt_mask).cpu().numpy().astype(bool)
        for i in range(rows.shape[0]):
            self._rows.append(rows[i][mask[i]])

    def add_batch_air(self, gt_fix, gt_len, gt_mask, pred_fix, pred_len,
                      performances, allocated):
        """AiR bucketed variant: ``performances`` is a ragged list (per
        image) of subject flags, ``allocated`` the stream flag of these
        predictions (True for good).  Mirrors
        evaluation_performance_related's NaN skip and (perf == alloc)
        bucketing (reference AiR/utils/evaluation.py:188-359)."""
        rows = self._compute_rows(gt_fix, gt_len, pred_fix, pred_len)
        mask = torch.as_tensor(gt_mask).cpu().numpy().astype(bool)
        for i in range(rows.shape[0]):
            r = rows[i][mask[i]]
            allr, right, wrong = [], [], []
            for row, perf in zip(r, performances[i]):
                if np.any(np.isnan(row)):
                    continue
                allr.append(row)
                if perf and allocated:
                    right.append(row)
                elif not perf and not allocated:
                    wrong.append(row)
            self._buckets.append((allr, right, wrong))

    def result(self):
        """(metrics, stds) with the host suite's exact aggregation."""
        if self._buckets:
            return _bucketize(self._buckets)
        sizes = [len(r) for r in self._rows]
        rows = np.concatenate([r for r in self._rows if len(r)], axis=0)
        return _summarize(rows, sizes)
