"""Host evaluation sweeps: human inter-observer baselines, GT-vs-predicted
metric suites, and the RL pair-reward functions (host reference
implementations; the training path computes rewards on device via
``metrics.jax_metrics``).

Behavioural contract: reference OSIE/utils/evaluation.py,
AiR/utils/evaluation.py, COCO_Search18/utils/evaluation.py.  Outputs are
the same nested metric dicts
``{MultiMatch:{vector,direction,length,position,duration},
   ScanMatch:{"w/o duration","with duration"}, VAME:{SED,STDE,SED_best,STDE_best}}``
(AiR additionally buckets into all / right_answer / wrong_answer).

Known reference quirk NOT replicated: the AiR evaluation stores the
with-duration ScanMatch score at index 5 but labels index 5
"w/o duration" (reference AiR/utils/evaluation.py:57-65 vs :144-147),
i.e. the two ScanMatch labels are swapped in AiR outputs only.  This
framework labels both consistently (the reference's model-selection
scalar is the harmonic mean over BOTH columns, so selection behaviour
is unaffected).

Group statistics use explicit per-group bookkeeping (the style of the
COCO reference) rather than OSIE's ``reshape(-1, len(fix_vectors)-1)``
which silently assumes a constant subject count; for constant-count
data the results are identical.

The port's own copy of ``scanpaths_tpu/metrics/evaluation.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import numpy as np

from .multimatch import docomparison
from .scanmatch import ScanMatch, make_scanmatch_pair
from .vame import scaled_time_delay_embedding_similarity, string_edit_distance

STIM_SHAPE = (240, 320, 3)


def _to_ms_array(fix_vector) -> np.ndarray:
    """Structured fixation vector (seconds) -> [L,3] array with ms."""
    a = np.stack([fix_vector["start_x"], fix_vector["start_y"],
                  fix_vector["duration"] * 1000.0], axis=-1) \
        if len(fix_vector) else np.zeros((0, 3))
    return a


def pair_metrics(fv1, fv2, sm_wd: ScanMatch, sm_wod: ScanMatch):
    """All 9 pairwise metrics for one (gt, pred) pair:
    [mm_vector, mm_direction, mm_length, mm_position, mm_duration,
     sm_wod, sm_wd, sed, stde]."""
    mm = docomparison(fv1, fv2, screensize=[320, 240])
    a, b = _to_ms_array(fv1), _to_ms_array(fv2)
    s1 = sm_wd.fixationToSequence(a).astype(np.int32)
    s2 = sm_wd.fixationToSequence(b).astype(np.int32)
    wd, _, _ = sm_wd.match(s1, s2)
    s1 = sm_wod.fixationToSequence(a).astype(np.int32)
    s2 = sm_wod.fixationToSequence(b).astype(np.int32)
    wod, _, _ = sm_wod.match(s1, s2)
    sed = string_edit_distance(STIM_SHAPE, a, b)
    stde = scaled_time_delay_embedding_similarity(a, b, STIM_SHAPE)
    if stde is None:  # empty scanpath (cannot occur with min_length >= 1)
        stde = np.nan
    return list(mm) + [wod, wd, sed, stde]


def _suite_dict(mean9, sed_best, stde_best):
    return {
        "MultiMatch": {"vector": mean9[0], "direction": mean9[1],
                       "length": mean9[2], "position": mean9[3],
                       "duration": mean9[4]},
        "ScanMatch": {"w/o duration": mean9[5], "with duration": mean9[6]},
        "VAME": {"SED": mean9[7], "STDE": mean9[8],
                 "SED_best": sed_best, "STDE_best": stde_best},
    }


def _summarize(rows: np.ndarray, group_sizes: list[int],
               mm_dropna: bool = True):
    """rows: [P, 9] pairwise metrics; group_sizes: pairs per best-group.
    Returns (metrics dict, std dict) with per-group SED_best/STDE_best.

    Reference semantics (OSIE/utils/evaluation.py:57-95,207-237): ONLY
    the MultiMatch mean/std drops NaN rows, and ONLY in ``evaluation``
    — ``human_evaluation`` does not filter at all, so a single
    <3-fixation subject makes the printed human MultiMatch baseline NaN
    (a reference quirk, reproduced with ``mm_dropna=False``).
    ScanMatch/SED/STDE means and the per-group bests use EVERY pair.
    (The AiR-bucketed callers pre-filter NaN pairs before reaching
    here, matching the AiR reference's earlier skip.)"""
    mm_ok = rows[~np.isnan(rows[:, :5].sum(axis=1))] if mm_dropna else rows
    mean9 = np.concatenate([mm_ok[:, :5].mean(0), rows[:, 5:].mean(0)]) \
        if len(mm_ok) else np.concatenate([np.full(5, np.nan),
                                           rows[:, 5:].mean(0)])
    std9 = np.concatenate([mm_ok[:, :5].std(0), rows[:, 5:].std(0)]) \
        if len(mm_ok) else np.concatenate([np.full(5, np.nan),
                                           rows[:, 5:].std(0)])
    sed_best, stde_best = [], []
    start = 0
    for g in group_sizes:
        chunk = rows[start:start + g]
        start += g
        if len(chunk):
            sed_best.append(chunk[:, 7].min())
            stde_best.append(chunk[:, 8].max())
    sed_best = np.asarray(sed_best)
    stde_best = np.asarray(stde_best)
    metrics = _suite_dict(mean9, sed_best.mean(), stde_best.mean())
    stds = _suite_dict(std9, sed_best.std(), stde_best.std())
    return metrics, stds


def human_evaluation(loader, task: str = "osie"):
    """Leave-one-out inter-observer scores over a loader of evaluation
    batches (reference OSIE/utils/evaluation.py:11-148;
    AiR variant buckets by answer-correctness pairs,
    AiR/utils/evaluation.py:11-186)."""
    sm_wd, sm_wod = make_scanmatch_pair()
    if task == "air":
        return _human_evaluation_air(loader, sm_wd, sm_wod)
    rows, group_sizes = [], []
    per_image = {}
    for batch in loader:
        for bi, fix_vectors in enumerate(batch["fix_vectors"]):
            img_scores = []
            for i in range(len(fix_vectors)):
                # the reference's best-groups are the leave-one-out
                # blocks per REFERENCE SUBJECT, not per image
                # (reshape(-1, len(fix_vectors)-1), evaluation.py:86-95)
                g = 0
                for j in range(len(fix_vectors)):
                    if i == j:
                        continue
                    r = pair_metrics(fix_vectors[i], fix_vectors[j],
                                     sm_wd, sm_wod)
                    rows.append(r)
                    img_scores.append(r)
                    g += 1
                group_sizes.append(g)
            per_image[batch["img_names"][bi]] = list(
                np.asarray(img_scores, np.float64).mean(axis=0))
    metrics, stds = _summarize(np.asarray(rows, np.float64), group_sizes,
                               mm_dropna=False)
    return metrics, stds, per_image


def evaluation(gt_fix_vectors, predict_fix_vectors):
    """GT-vs-predicted sweep (reference OSIE/utils/evaluation.py:151-282).
    ``gt_fix_vectors`` is a list (one entry per prediction) of lists of
    subject vectors."""
    sm_wd, sm_wod = make_scanmatch_pair()
    rows, group_sizes = [], []
    per_image = []
    for gts, pred in zip(gt_fix_vectors, predict_fix_vectors):
        g = 0
        img_scores = []
        for gt in gts:
            r = pair_metrics(gt, pred, sm_wd, sm_wod)
            rows.append(r)
            img_scores.append(r)
            g += 1
        group_sizes.append(g)
        per_image.append(list(np.asarray(img_scores, np.float64)
                              .mean(axis=0)))
    metrics, stds = _summarize(np.asarray(rows, np.float64), group_sizes)
    return metrics, stds, per_image


# ---------------------------------------------------------------------------
# AiR performance-bucketed variants
# ---------------------------------------------------------------------------

def _bucketize(rows_by_group):
    """rows_by_group: list of (all, right, wrong) row-lists."""
    cats = {"all": [], "right_answer": [], "wrong_answer": []}
    sizes = {k: [] for k in cats}
    for allr, right, wrong in rows_by_group:
        for key, lst in (("all", allr), ("right_answer", right),
                         ("wrong_answer", wrong)):
            if lst:
                cats[key].extend(lst)
                sizes[key].append(len(lst))
    out_m, out_s = {}, {}
    for key in cats:
        m, s = _summarize(np.asarray(cats[key], np.float64), sizes[key])
        out_m[key], out_s[key] = m, s
    return out_m, out_s


def _human_evaluation_air(loader, sm_wd, sm_wod):
    rows_by_group = []
    per_qid = {}
    for batch in loader:
        for bi, (fix_vectors, performances) in enumerate(
                zip(batch["fix_vectors"], batch["performances"])):
            allr, right, wrong = [], [], []
            for i in range(len(fix_vectors)):
                for j in range(len(fix_vectors)):
                    if i == j:
                        continue
                    r = pair_metrics(fix_vectors[i], fix_vectors[j],
                                     sm_wd, sm_wod)
                    if np.any(np.isnan(r)):
                        # reference AiR skips NaN pairs entirely (:47-48)
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
    m, s = _bucketize(rows_by_group)
    return m, s, per_qid


def evaluation_performance_related(gt_fix_vectors, predict_fix_vectors,
                                   all_performances,
                                   all_allocated_performances):
    """AiR GT-vs-predicted sweep bucketed by (subject performance ==
    allocated stream) (reference AiR/utils/evaluation.py:188-359)."""
    sm_wd, sm_wod = make_scanmatch_pair()
    rows_by_group = []
    per_image = []
    for gts, pred, perfs, alloc in zip(gt_fix_vectors, predict_fix_vectors,
                                       all_performances,
                                       all_allocated_performances):
        allr, right, wrong = [], [], []
        for gt, perf in zip(gts, perfs):
            r = pair_metrics(gt, pred, sm_wd, sm_wod)
            if np.any(np.isnan(r)):
                continue
            allr.append(r)
            if perf and alloc:
                right.append(r)
            elif (not perf) and (not alloc):
                wrong.append(r)
        rows_by_group.append((allr, right, wrong))
        chosen = right if alloc else wrong
        per_image.append(list(np.asarray(chosen, np.float64).mean(0))
                         if chosen else [0.0] * 9)
    m, s = _bucketize(rows_by_group)
    return m, s, per_image


# ---------------------------------------------------------------------------
# RL pair-reward functions (host reference implementations)
# ---------------------------------------------------------------------------

def pairs_eval(gt_fix_vectors, predict_fix_vectors, sm_wd, sm_wod):
    """OSIE RL reward rows [N, 11] (reference OSIE/utils/evaluation.py:284-340).
    Columns: mm(5), sm_wod, sm_wd, sed, stde, sed_best, stde_best;
    NaN MultiMatch voids the pair, means normalize by the TOTAL subject
    count."""
    out = []
    for gts, pred in zip(gt_fix_vectors, predict_fix_vectors):
        rows = []
        for gt in gts:
            mm = docomparison(gt, pred, screensize=[320, 240])
            if np.any(np.isnan(mm)):
                rows.append(list(mm) + [np.nan] * 4)
            else:
                rows.append(pair_metrics(gt, pred, sm_wd, sm_wod))
        rows = np.asarray(rows, np.float64)
        valid = rows[~np.isnan(rows.sum(axis=1))]
        if valid.shape[0] != 0:
            mean = valid.sum(0) / len(gts)
            vals = np.zeros(11, np.float32)
            vals[:9] = mean[:9]
            vals[9] = valid[:, 7].min()
            vals[10] = valid[:, 8].max()
        else:
            vals = np.full(11, np.nan)
        out.append(vals)
    return np.asarray(out)


def pairs_eval_scanmatch(gt_fix_vectors, predict_fix_vectors, sm_wd, sm_wod):
    """COCO RL reward rows [N, 2] = mean [sm_wod, sm_wd] over subjects
    (reference COCO_Search18/utils/evaluation.py:313-352)."""
    out = []
    for gts, pred in zip(gt_fix_vectors, predict_fix_vectors):
        rows = []
        for gt in gts:
            r = pair_metrics(gt, pred, sm_wd, sm_wod)
            rows.append([r[5], r[6]])
        rows = np.asarray(rows, np.float64)
        valid = rows[~np.isnan(rows.sum(axis=1))]
        out.append(valid.sum(0) / len(gts) if valid.shape[0] else
                   np.full(2, np.nan))
    return np.asarray(out)


def pairs_eval_scanmatch_performance_related(gt_fix_vectors,
                                             predict_fix_vectors, sm_wd,
                                             sm_wod, performance,
                                             given_performance):
    """AiR RL same/diff-group rewards (reference AiR/utils/evaluation.py:361-422).
    Group means normalize by the VALID row count; empty groups -> NaN and
    a False accept flag when non-empty groups lose all rows to NaN."""
    accept = True
    same_out, diff_out = [], []
    for gts, pred, perfs in zip(gt_fix_vectors, predict_fix_vectors,
                                performance):
        same, diff = [], []
        for gt, perf in zip(gts, perfs):
            r = pair_metrics(gt, pred, sm_wd, sm_wod)
            row = [r[5], r[6]]
            (same if perf == given_performance else diff).append(row)
        for rows, acc in ((same, same_out), (diff, diff_out)):
            arr = np.asarray(rows, np.float64)
            if arr.shape[0]:
                valid = arr[~np.isnan(arr.sum(axis=1))]
                if valid.shape[0] == 0:
                    accept = False
                    acc.append(np.full(2, np.nan))
                else:
                    acc.append(valid.sum(0) / valid.shape[0])
            else:
                acc.append(np.full(2, np.nan))
    return np.asarray(same_out), np.asarray(diff_out), accept


def gtpairs_eval_scanmatch_performance_related(gt_fix_vectors, sm_wd, sm_wod,
                                               performance):
    """AiR GT-vs-GT group scores (reference AiR/utils/evaluation.py:425-577):
    per question, mean [sm_wod, sm_wd] over good-good, poor-poor, and
    good-vs-poor subject pairs; singleton groups give NaN."""
    good_out, poor_out, diff_out = [], [], []
    for gts, perfs in zip(gt_fix_vectors, performance):
        good = [g for g, p in zip(gts, perfs) if p]
        poor = [g for g, p in zip(gts, perfs) if not p]

        def pair_rows(a, b, cross):
            rows = []
            if cross:
                if len(a) > 1 and len(b) > 1:
                    for va in a:
                        for vb in b:
                            r = pair_metrics(va, vb, sm_wd, sm_wod)
                            rows.append([r[5], r[6]])
            else:
                if len(a) > 1:
                    for i in range(len(a)):
                        for j in range(i + 1, len(a)):
                            r = pair_metrics(a[i], a[j], sm_wd, sm_wod)
                            rows.append([r[5], r[6]])
            arr = np.asarray(rows, np.float64)
            if arr.shape[0]:
                valid = arr[~np.isnan(arr.sum(axis=1))]
                if valid.shape[0]:
                    return valid.sum(0) / valid.shape[0]
            return np.full(2, np.nan)

        good_out.append(pair_rows(good, good, cross=False))
        poor_out.append(pair_rows(poor, poor, cross=False))
        diff_out.append(pair_rows(good, poor, cross=True))
    return (np.asarray(good_out), np.asarray(poor_out), np.asarray(diff_out))
