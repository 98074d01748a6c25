"""Synthetic OSIE corpora (the port's copy of
``tools/make_synth_data.py``'s ``make_osie``, ``make_osie_structured``
and ``make_osie_headroom`` with their helpers): the same seed writes
byte-identical trees.  ``make_osie`` is the uniform-random corpus the
input-pipeline benchmarks load; ``make_osie_headroom`` is the
convergence run's.

Layout written under ``root``: ``stimuli/*.jpg`` and
``fixations/osie_fixations_{split}.json``.

:func:`make_osie_release` (the port's own) writes OSIE in the form of
its public release instead, a ``fixations.mat`` to preprocess, for the
real-data drive (``tools/real_data_smoke.py``).
"""

from __future__ import annotations

import json
import os
from os.path import join

import numpy as np
from PIL import Image


def _write_image(path, rng, hw):
    arr = rng.integers(0, 255, size=(*hw, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


def _scanpath(rng, w, h, min_len=3, max_len=14):
    l = int(rng.integers(min_len, max_len + 1))
    return (rng.uniform(0, w - 1, l).tolist(), rng.uniform(0, h - 1, l).tolist(),
            rng.uniform(120, 640, l).tolist(), l)


def make_osie(root, rng, n_images=6, n_subjects=4,
              splits=("train", "validation", "test")):
    os.makedirs(join(root, "stimuli"), exist_ok=True)
    os.makedirs(join(root, "fixations"), exist_ok=True)
    per_split = {}
    img_id = 0
    for split in splits:
        recs = []
        for _ in range(n_images):
            name = f"{1001 + img_id}.jpg"
            img_id += 1
            _write_image(join(root, "stimuli", name), rng, (600, 800))
            for _ in range(n_subjects):
                x, y, t, l = _scanpath(rng, 800, 600)
                recs.append({"name": name, "subject": int(rng.integers(0, 99)),
                             "X": x, "Y": y, "T": t, "length": l,
                             "split": split})
        per_split[split] = recs
        with open(join(root, "fixations", f"osie_fixations_{split}.json"),
                  "w") as f:
            json.dump(recs, f)
    return per_split


def make_osie_structured(root, rng, n_train=64, n_val=8, n_subjects=8,
                         n_blobs=3, noise_px=15, order_swap_p=0.0,
                         dwell_noise_ms=20):
    """A LEARNABLE synthetic OSIE corpus for convergence runs
    (``tools/convergence_run.py``): images are dark with ``n_blobs`` bright
    rectangles; every subject fixates the blob centers in salience
    order (with spatial noise and an occasional revisit) and dwells
    proportionally to blob brightness.  A model must therefore learn an
    image -> scanpath mapping — supervised loss, validation ScanMatch
    and the SCST reward all have genuine headroom over a random-init
    policy, unlike the uniform-random corpus of :func:`make_osie`.

    ``noise_px`` / ``order_swap_p`` / ``dwell_noise_ms`` control how
    noisy a sample of the image's underlying program each SUBJECT is
    (spatial scatter around the blob centers, probability of swapping
    the 2nd/3rd blob in the visit order, dwell-time scatter).  See
    :func:`make_osie_headroom` for why cranking them creates the
    supervised-vs-RL headroom the reference's two-phase schedule
    exists to exploit."""
    os.makedirs(join(root, "stimuli"), exist_ok=True)
    os.makedirs(join(root, "fixations"), exist_ok=True)
    img_id = 0
    for split, n_images in (("train", n_train), ("validation", n_val),
                            ("test", n_val)):
        recs = []
        for _ in range(n_images):
            name = f"{5001 + img_id}.jpg"
            img_id += 1
            arr = np.full((600, 800, 3), 20, np.uint8)
            centers = rng.uniform((100, 100), (700, 500), (n_blobs, 2))
            sal = rng.uniform(0.4, 1.0, n_blobs)
            for (cx, cy), s in zip(centers, sal):
                x0, y0 = int(cx) - 60, int(cy) - 45
                arr[max(y0, 0):y0 + 90, max(x0, 0):x0 + 120] = \
                    int(80 + 175 * s)
            Image.fromarray(arr).save(join(root, "stimuli", name))
            order = np.argsort(-sal)
            for subj in range(n_subjects):
                visit = list(order)
                if n_blobs >= 3 and rng.uniform() < order_swap_p:
                    visit[1], visit[2] = visit[2], visit[1]
                seq = visit + [int(visit[0])]
                length = n_blobs + int(rng.integers(0, 2))
                xs, ys, ts = [], [], []
                for b in seq[:length]:
                    xs.append(float(np.clip(
                        centers[b, 0] + rng.normal(0, noise_px), 0, 799)))
                    ys.append(float(np.clip(
                        centers[b, 1] + rng.normal(0, noise_px), 0, 599)))
                    ts.append(float(max(
                        150 + 450 * sal[b]
                        + rng.normal(0, dwell_noise_ms), 80)))
                recs.append({"name": name, "subject": subj + 1,
                             "X": xs, "Y": ys, "T": ts,
                             "length": length, "split": split})
        with open(join(root, "fixations",
                       f"osie_fixations_{split}.json"), "w") as f:
            json.dump(recs, f)
    return root


def make_osie_headroom(root, rng, **kw):
    """The RL-lift corpus: subjects are NOISY, ORDER-AMBIGUOUS samples
    of each image's underlying blob program, so the supervised snapshot
    is NOT at the reward ceiling and SCST has genuine headroom above it
    (the lift the reference's two-phase schedule exists to produce,
    reference OSIE/train.py:252-258).

    Why headroom exists here and not in the tight corpus
    (make_osie_structured defaults): teacher-forced CE learns the
    per-step MARGINAL over subjects.  With sigma=40 px scatter (2
    action-grid cells / 0.8 ScanMatch bins at the 800->320 rescale),
    a 30% chance of swapping the 2nd/3rd blob, and 100 ms dwell
    scatter, that marginal is diffuse and bimodal — so SAMPLING from
    it compounds subject scatter with policy entropy (and can mix
    visit orders mid-rollout).  The sequence-level ScanMatch reward is
    instead maximized by committing to the central mode: a lower-
    entropy policy strictly beats the marginal it was distilled from.
    CE cannot reach that policy (its optimum IS the marginal);
    REINFORCE on the sampled sequence score can — the classic
    exposure/variance gap SCST closes.  Measured on the host metric
    oracle (12 images x 8 subjects, 2026-08-21): subject-vs-subject
    hmean(ScanMatch) = 0.433 (the marginal-sampling ceiling) vs
    mode-vs-subject = 0.529 — ~0.10 of corpus-level headroom before
    counting the policy-entropy reduction itself."""
    return make_osie_structured(root, rng, noise_px=40, order_swap_p=0.3,
                                dwell_noise_ms=100, **kw)


def _track(x, y, t):
    arr = np.zeros((1, 1), dtype=[("x", "O"), ("y", "O"), ("t", "O")])
    arr[0, 0] = (np.asarray(x, float)[None, :],
                 np.asarray(y, float)[None, :],
                 np.asarray(t, float)[None, :])
    return arr


def _example(name, tracks):
    subjects = np.zeros((len(tracks), 1), dtype=object)
    for i, tr in enumerate(tracks):
        subjects[i, 0] = tr
    arr = np.zeros((1, 1), dtype=[("img", "O"), ("subjects", "O")])
    arr[0, 0] = (np.array([name]), subjects)
    return arr


def make_osie_release(root, rng, n_trainval=9, n_test=2, n_subjects=4):
    """OSIE in its release's form under ``root``: ``osie/stimuli/*.jpg``
    (800x600) and ``osie/fixations.mat``, the struct array
    ``data/preprocess.py::preprocess_osie`` reads (one ``img`` and
    ``subjects`` of x, y, t tracks an image; 3-6 fixations of 150-500
    ms).  ``n_trainval`` images go to the 8:1 train/validation split and
    ``n_test`` of the fixed test list to the test split.  With the
    defaults and ``default_rng(0)`` it is ``tests/test_real_data_smoke.py``'s
    layout: 32 train, 4 validation and 8 test records."""
    import scipy.io as sio

    from ..data.preprocess import OSIE_TEST_IMAGES
    stimuli = join(root, "osie", "stimuli")
    os.makedirs(stimuli, exist_ok=True)
    names = ([f"{3000 + i}.jpg" for i in range(n_trainval)]
             + OSIE_TEST_IMAGES[:n_test])
    fx = np.zeros((len(names), 1), dtype=object)
    for i, name in enumerate(names):
        Image.fromarray(rng.integers(0, 255, (600, 800, 3),
                                     dtype=np.uint8)).save(join(stimuli,
                                                                name))
        tracks = []
        for _ in range(n_subjects):
            n = int(rng.integers(3, 7))
            tracks.append(_track(rng.uniform(0, 800, n),
                                 rng.uniform(0, 600, n),
                                 rng.uniform(150, 500, n)))
        fx[i, 0] = _example(name, tracks)
    sio.savemat(join(root, "osie", "fixations.mat"), {"fixations": fx})
    return root
