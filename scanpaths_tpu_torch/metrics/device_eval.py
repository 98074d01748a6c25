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

Over ranks (``train/mesh.py``) each rank computes the rows of its rows
of every batch; rank 0 gathers them in one process's order (not sums:
the standard deviations and the AiR buckets need every row) and
aggregates, and every rank returns rank 0's result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.datasets import batches_of
from ..train import mesh
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


def _human_images(m, batch):
    """Per image of a batch, from its [N, S, S, 9] :func:`human_rows`:
    (name, the leave-one-out rows, their group sizes)."""
    mask = np.asarray(batch["gt_mask"]).astype(bool)
    out = []
    for bi in range(m.shape[0]):
        ns = int(mask[bi].sum())
        rows, sizes = [], []
        for i in range(ns):
            rows.extend(m[bi, i, j] for j in range(ns) if j != i)
            sizes.append(ns - 1)
        out.append((batch["img_names"][bi], rows, sizes))
    return out


def _human_images_air(m, batch):
    """AiR per image (reference AiR/utils/evaluation.py:11-186: NaN pairs
    skipped entirely, buckets by answer-correctness pairs): (question id,
    all rows, right-answer pairs, wrong-answer pairs)."""
    mask = np.asarray(batch["gt_mask"]).astype(bool)
    out = []
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
        out.append((batch["question_ids"][bi], allr, right, wrong))
    return out


def _human_summary(images):
    rows = [r for _, rs, _ in images for r in rs]
    sizes = [g for _, _, gs in images for g in gs]
    per_image = {name: list(np.asarray(rs, np.float64).mean(axis=0))
                 for name, rs, _ in images}
    metrics, stds = _summarize(np.asarray(rows, np.float64), sizes,
                               mm_dropna=False)
    return metrics, stds, per_image


def _human_summary_air(images):
    per_qid = {}
    for qid, _, right, wrong in images:
        good = list(np.asarray(right, np.float64).mean(0)) if right \
            else [0.0] * 9
        poor = list(np.asarray(wrong, np.float64).mean(0)) if wrong \
            else [0.0] * 9
        per_qid[qid] = {True: good, False: poor}
    metrics, stds = _bucketize([img[1:] for img in images])
    return metrics, stds, per_qid


def human_evaluation_device(loader, spec_wd: tm.ScanMatchSpec,
                            spec_wod: tm.ScanMatchSpec, task: str = "osie",
                            device="cuda"):
    """Device human inter-observer baseline — the drop-in replacement
    for ``evaluation.human_evaluation`` under ``--device_eval`` (same
    (metrics, stds, per_image) return tree, aggregation shared with the
    host suite; AiR bucketed by answer correctness).  Batches are host
    (numpy) batches; their GT goes to ``device``, the card unless the
    caller asks for the CPU.  Over ranks each rank computes the rows of
    the rows it counts (``mesh.counts_rows``) and every rank returns rank
    0's aggregate of all of them."""
    per_batch = _human_images_air if task == "air" else _human_images
    chunks = []
    for b, (batch, sliced) in enumerate(batches_of(loader)):
        if not mesh.counts_rows(sliced):
            continue
        m = human_rows(spec_wd, spec_wod, *_gt_tensors(batch, device))
        chunks.append(((b, mesh.row_offset(sliced, m.shape[0])),
                       per_batch(m, batch)))
    gathered = mesh.gather_to_primary(chunks)
    result = None
    if gathered is not None:
        images = [img for _, imgs in gathered for img in imgs]
        result = (_human_summary_air if task == "air"
                  else _human_summary)(images)
    return mesh.broadcast_object(result)


class DeviceSweep:
    """Accumulates device-computed pair rows across evaluation batches
    and reproduces ``evaluation(...)``'s aggregation exactly, or, fed by
    :meth:`add_batch_air`, ``evaluation_performance_related(...)``'s.
    Each add takes a ``key`` that orders it as one process adds it; over
    ranks :meth:`result` gathers every rank's adds to rank 0 in key
    order."""

    def __init__(self, spec_wd: tm.ScanMatchSpec,
                 spec_wod: tm.ScanMatchSpec):
        self.spec_wd = spec_wd
        self.spec_wod = spec_wod
        # (key, (per-image groups, truncated rollouts, rollouts)) per add;
        # a group is an image's [G, 9] rows, or for AiR its (all, right,
        # wrong) buckets
        self._adds: list = []
        self._air = False
        self._overflow = 0                     # truncated rollouts
        self._preds = 0                        # rollouts seen

    @property
    def overflow(self) -> dict:
        """{count, total, frac} of prediction rollouts whose TempBin
        expansion overflowed the w/-duration table (prefix-truncated on
        the device; a nonzero frac means the with-duration ScanMatch
        column may read differently from a host-suite run); over ranks,
        after :meth:`result`, the counts of every rank."""
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

    def _compute_rows(self, gt_fix, gt_len, pred_fix, pred_len):
        """Pair rows and the overflow count, read back together in one
        host sync.  Inputs are tensors on one device."""
        rows = pair_rows(self.spec_wd, self.spec_wod, gt_fix, gt_len,
                         pred_fix, pred_len)
        ov = tm.expansion_overflow(self.spec_wd, pred_fix, pred_len).sum()
        out = torch.cat([rows.reshape(-1).double(), ov.double()[None]])
        out = out.cpu().numpy()
        self._overflow += int(out[-1])
        self._preds += int(pred_len.shape[0])
        return out[:-1].reshape(rows.shape), int(out[-1])

    def add_batch(self, gt_fix, gt_len, gt_mask, pred_fix, pred_len,
                  key=()):
        """One decode repeat of one batch: gt_* [N, S, ...] (mask 1 =
        real subject), pred_* [N, ...]."""
        rows, ov = self._compute_rows(gt_fix, gt_len, pred_fix, pred_len)
        mask = torch.as_tensor(gt_mask).cpu().numpy().astype(bool)
        self._adds.append((key, ([rows[i][mask[i]]
                                  for i in range(rows.shape[0])],
                                 ov, rows.shape[0])))

    def add_batch_air(self, gt_fix, gt_len, gt_mask, pred_fix, pred_len,
                      performances, allocated, key=()):
        """AiR bucketed variant: ``performances`` is a ragged list (per
        image) of subject flags, ``allocated`` the stream flag of these
        predictions (True for good).  Mirrors
        evaluation_performance_related's NaN skip and (perf == alloc)
        bucketing (reference AiR/utils/evaluation.py:188-359)."""
        rows, ov = self._compute_rows(gt_fix, gt_len, pred_fix, pred_len)
        mask = torch.as_tensor(gt_mask).cpu().numpy().astype(bool)
        buckets = []
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
            buckets.append((allr, right, wrong))
        self._air = True
        self._adds.append((key, (buckets, ov, rows.shape[0])))

    def result(self):
        """(metrics, stds) with the host suite's exact aggregation, on
        every rank (rank 0's, of every rank's adds in key order)."""
        gathered = mesh.gather_to_primary(self._adds)
        out = None
        if gathered is not None:
            groups = [g for _, (gs, _, _) in gathered for g in gs]
            counts = (sum(v[1] for _, v in gathered),
                      sum(v[2] for _, v in gathered))
            if self._air:
                out = _bucketize(groups) + counts
            else:
                sizes = [len(r) for r in groups]
                rows = np.concatenate([r for r in groups if len(r)], axis=0)
                out = _summarize(rows, sizes) + counts
        metrics, stds, self._overflow, self._preds = \
            mesh.broadcast_object(out)
        return metrics, stds
