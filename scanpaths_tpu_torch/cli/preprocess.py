"""Offline preprocessing entry point: raw datasets -> split fixation
JSONs (the reference's run-once scripts,
OSIE/preprocess/preprocess_fixations.py and
AiR/preprocess/preprocess_fixations.py, behind one CLI).

  python -m scanpaths_tpu.cli.preprocess osie \
      --fixations_mat data/eye/fixations.mat --out_dir data/fixations

  python -m scanpaths_tpu.cli.preprocess air \
      --consolidated_answers .../consolidated_answers.json \
      --questions .../val_balanced_questions.json \
      --scene_graphs .../val_sceneGraphs.json \
      --fix_root .../fix --gqa_images .../GQA/images \
      --out_dir data/fixations

COCO-Search18 ships with upstream splits and needs no preprocessing.

The port's own copy of ``scanpaths_tpu/cli/preprocess.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="dataset", required=True)

    po = sub.add_parser("osie")
    po.add_argument("--fixations_mat", required=True)
    po.add_argument("--out_dir", required=True)

    pa = sub.add_parser("air")
    pa.add_argument("--consolidated_answers", required=True)
    pa.add_argument("--questions", required=True)
    pa.add_argument("--scene_graphs", required=True)
    pa.add_argument("--fix_root", required=True)
    pa.add_argument("--gqa_images", required=True)
    pa.add_argument("--out_dir", required=True)

    args = p.parse_args(argv)
    from ..data import preprocess

    if args.dataset == "osie":
        preprocess.preprocess_osie(args.fixations_mat, args.out_dir)
    else:
        preprocess.preprocess_air(
            args.consolidated_answers, args.questions, args.scene_graphs,
            args.fix_root, args.gqa_images, args.out_dir)
    print(f"wrote split JSONs to {args.out_dir}")


if __name__ == "__main__":
    main()
