"""Offline preprocessing: raw datasets -> split fixation JSONs.

Ports of the reference's run-once scripts
(reference OSIE/preprocess/preprocess_fixations.py:1-106,
AiR/preprocess/preprocess_fixations.py:1-183), emitting byte-compatible
record schemas.  COCO-Search18 ships with upstream splits and needs no
preprocessing.

Split semantics preserved exactly:
* OSIE: the fixed 70-image test list from the IOR-ROI paper; remaining
  images shuffled with ``np.random.seed(0)`` and split 8:1 train/val;
* AiR: question ids shuffled with ``np.random.seed(0)`` and split
  80/10/10; a subject with an empty fixation track aborts that
  question's remaining subjects (the reference ``break``), and every
  record embeds the GQA question fields, image size, subject answer,
  accuracy and scene-graph objects.

The port's own copy of ``scanpaths_tpu/data/preprocess.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import json
import os
from os.path import join

import numpy as np
import scipy.io as sio

# The fixed OSIE test set from "Visual Scanpath Prediction using IOR-ROI
# Recurrent Mixture Density Network" (reference OSIE preprocess:7-16).
OSIE_TEST_IMAGES = [
    "1009.jpg", "1017.jpg", "1049.jpg", "1056.jpg", "1062.jpg", "1086.jpg",
    "1087.jpg", "1099.jpg", "1108.jpg", "1114.jpg", "1116.jpg", "1117.jpg",
    "1127.jpg", "1130.jpg", "1131.jpg", "1136.jpg", "1140.jpg", "1152.jpg",
    "1192.jpg", "1220.jpg", "1225.jpg", "1226.jpg", "1252.jpg", "1255.jpg",
    "1269.jpg", "1295.jpg", "1307.jpg", "1360.jpg", "1369.jpg", "1372.jpg",
    "1394.jpg", "1397.jpg", "1405.jpg", "1420.jpg", "1423.jpg", "1433.jpg",
    "1441.jpg", "1478.jpg", "1480.jpg", "1481.jpg", "1489.jpg", "1490.jpg",
    "1493.jpg", "1502.jpg", "1509.jpg", "1523.jpg", "1528.jpg", "1530.jpg",
    "1549.jpg", "1555.jpg", "1558.jpg", "1567.jpg", "1576.jpg", "1581.jpg",
    "1595.jpg", "1596.jpg", "1605.jpg", "1609.jpg", "1615.jpg", "1616.jpg",
    "1618.jpg", "1622.jpg", "1628.jpg", "1637.jpg", "1640.jpg", "1657.jpg",
    "1663.jpg", "1677.jpg", "1682.jpg", "1699.jpg",
]


def preprocess_osie(fixations_mat: str, out_dir: str):
    """fixations.mat -> osie_fixations_{train,validation,test}.json."""
    data = sio.loadmat(fixations_mat)
    fixations = data["fixations"]

    np.random.seed(0)
    trainval = []
    for example in fixations:
        name = example[0][0][0][0].item()
        if name not in OSIE_TEST_IMAGES:
            trainval.append(name)
    np.random.shuffle(trainval)
    n = len(trainval)
    train_names = set(trainval[: int(n * 8.0 / 9.0)])
    val_names = set(trainval[int(n * 8.0 / 9.0):])

    def records_for(names, split):
        out = []
        for example in fixations:
            ev = example[0][0][0]
            if ev[0].item() not in names:
                continue
            detail = ev[1]
            for idx in range(len(detail)):
                track = detail[idx][0][0][0]
                out.append({
                    "name": ev[0].item(),
                    "subject": idx + 1,
                    "X": track[0].squeeze(0).tolist(),
                    "Y": track[1].squeeze(0).tolist(),
                    "T": track[2].squeeze(0).tolist(),
                    "length": track[0].squeeze(0).shape[0],
                    "split": split,
                })
        return out

    os.makedirs(out_dir, exist_ok=True)
    for names, split in ((train_names, "train"), (val_names, "validation"),
                         (set(OSIE_TEST_IMAGES), "test")):
        with open(join(out_dir, f"osie_fixations_{split}.json"), "w") as f:
            json.dump(records_for(names, split), f, indent=2)


def preprocess_air(consolidated_answers_json: str,
                   val_balanced_questions_json: str,
                   val_scene_graphs_json: str, fix_root: str,
                   gqa_images_dir: str, out_dir: str,
                   image_size_fn=None):
    """AiR fixation .mat tracks + GQA annotations ->
    AiR_fixations_{train,validation,test}.json.

    ``image_size_fn(img_path) -> (H, W)`` defaults to PIL (the reference
    reads the full image with skimage just for its shape).
    """
    if image_size_fn is None:
        from PIL import Image

        def image_size_fn(path):
            with Image.open(path) as im:
                return im.height, im.width

    with open(consolidated_answers_json) as f:
        consolidated = json.load(f)
    with open(val_balanced_questions_json) as f:
        questions = json.load(f)
    with open(val_scene_graphs_json) as f:
        scene_graphs = json.load(f)

    qids = list(consolidated["accuracy"])
    image_ids = {q: questions[q]["imageId"] for q in qids}

    np.random.seed(0)
    np.random.shuffle(qids)
    n = len(qids)
    splits = {
        "train": qids[: int(n * 0.8)],
        "validation": qids[int(n * 0.8): int(n * 0.9)],
        "test": qids[int(n * 0.9):],
    }

    os.makedirs(out_dir, exist_ok=True)
    for split, split_qids in splits.items():
        records = []
        for qid in split_qids:
            fix_dir = join(fix_root, qid)
            img_id = image_ids[qid] + ".jpg"
            h, w = image_size_fn(join(gqa_images_dir, img_id))
            for fix_file in os.listdir(fix_dir):
                rec = dict(questions[qid])
                fix = sio.loadmat(join(fix_dir, fix_file))
                subject = fix_file.split(".")[0]
                rec.update(image_id=img_id, subject=subject,
                           question_id=qid, height=h, width=w)
                if fix["xy"].shape[0] == 0:
                    # reference aborts the remaining subjects of this
                    # question (preprocess_fixations.py:61-64)
                    break
                rec["X"] = fix["xy"][:, 0].tolist()
                rec["Y"] = fix["xy"][:, 1].tolist()
                rec["T_start"] = fix["t"][:, 0].tolist()
                rec["T_end"] = fix["t"][:, 1].tolist()
                rec["length"] = fix["t"].shape[0]
                rec["subject_answer"] = consolidated[subject][qid]
                rec["accuracy"] = consolidated["accuracy"][qid]
                rec["split"] = split
                rec["objects"] = scene_graphs[image_ids[qid]]["objects"]
                records.append(rec)
        with open(join(out_dir, f"AiR_fixations_{split}.json"), "w") as f:
            json.dump(records, f, indent=2)
