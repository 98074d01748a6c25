"""Layered configuration system.

Reproduces the reference's override precedence exactly
(reference AiR/opts.py:41-71 + AiR/utils/config.py yacs CfgNode):

  argparse defaults  <  --cfg yaml (with recursive ``_BASE_``
  inheritance)  <  --set_cfgs k v ...  <  explicit CLI flags

Unknown yaml keys warn instead of failing (opts.py:63-64).  One parser
serves all three tasks; per-task defaults follow the reference opts
files (OSIE seed=10 / wd=5e-4; AiR seed=0 / wd=5e-5 / lambda_5; COCO
seed=0 / wd=5e-4 / detector_threshold=0.8).

The port's own copy of ``scanpaths_tpu/core/config.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import argparse
import copy
import os

import yaml

BASE_KEY = "_BASE_"


def str2bool(v) -> bool:
    """Tolerant boolean CLI values: the reference's ``type=bool`` flags
    treat any non-empty string (including 'False') as True; the flags
    NEW to this framework use this converter instead so '--flag False'
    does what it says."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def remat_mode(v):
    """--remat values: booleans (back-compat) or a mode name
    (models/scanpath_model.py ScanpathModel.remat)."""
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("none", "all", "backbone", "scan", "scan_policy", "policy"):
        return s
    try:
        return str2bool(s)
    except argparse.ArgumentTypeError:
        raise argparse.ArgumentTypeError(
            f"remat mode expected (bool or none/all/backbone/scan/"
            f"scan_policy/policy), got {v!r}")


def load_yaml_with_base(path: str) -> dict:
    """Load a yaml file, recursively merging a ``_BASE_`` parent
    (reference utils/config.py:33-77)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if BASE_KEY in cfg:
        base_path = cfg.pop(BASE_KEY)
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_path)
        base = load_yaml_with_base(base_path)
        merged = _merge(base, cfg)
        return merged
    return cfg


def _merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def merge_set_cfgs(cfg: dict, set_cfgs: list[str]) -> dict:
    """Merge a flat ``k v k v ...`` override list (yaml-parsed values)."""
    assert len(set_cfgs) % 2 == 0, "set_cfgs expects key value pairs"
    out = dict(cfg)
    for k, v in zip(set_cfgs[0::2], set_cfgs[1::2]):
        out[k] = yaml.safe_load(v)
    return out


TASK_DEFAULTS = {
    "osie": dict(seed=10, weight_decay=5e-4, img_dir="./data/stimuli",
                 fix_dir="./data/fixations"),
    "air": dict(seed=0, weight_decay=5e-5, img_dir="./data/stimuli",
                fix_dir="./data/fixations"),
    "coco": dict(seed=0, weight_decay=5e-4, img_dir="./data/images",
                 fix_dir="./data/fixations"),
    # joint multi-task training over all three datasets (new capability
    # of the rebuild — BASELINE.json config 5)
    "joint": dict(seed=0, weight_decay=5e-4, img_dir="./data",
                  fix_dir="./data"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Scanpath prediction for images (TPU-native)")
    p.add_argument("--task", type=str, default="osie",
                   choices=("osie", "air", "coco", "joint"))
    p.add_argument("--joint_data_root", type=str, default="./data",
                   help="root holding osie/ air/ coco/ dataset trees "
                        "for --task joint")
    p.add_argument("--mode", type=str, default="train")
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--fix_dir", type=str, default=None)
    p.add_argument("--att_dir", type=str, default=None,
                   help="AiR attention maps dir")
    p.add_argument("--detector_dir", type=str, default=None,
                   help="COCO detector results dir")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--map_width", type=int, default=40)
    p.add_argument("--map_height", type=int, default=30)
    p.add_argument("--blur_sigma", type=float, default=None)
    p.add_argument("--detector_threshold", type=float, default=0.8)
    p.add_argument("--clip", type=float, default=12.5)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--epoch", type=int, default=10)
    p.add_argument("--warmup_epoch", type=int, default=1)
    p.add_argument("--start_rl_epoch", type=int, default=5)
    p.add_argument("--rl_sample_number", type=int, default=5)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--rl_lr_initial_decay", type=float, default=0.5)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--bf16_moments", type=str2bool, default=False,
                   help="store the first Adam moment in bfloat16 "
                        "(optax mu_dtype) — an HBM probe knob, not a "
                        "parity setting (train/schedule.py)")
    p.add_argument("--log_root", type=str, default="./assets")
    p.add_argument("--resume_dir", type=str, default="")
    p.add_argument("--center_bias", type=str2bool, default=True)
    p.add_argument("--lambda_1", type=float, default=1.0)
    p.add_argument("--lambda_5", type=float, default=-2.0)
    p.add_argument("--apply_consistency_divergence", action="store_true",
                   help="Actually add the AiR Consistency-Divergence RL "
                        "term to the loss.  OFF by default: the reference "
                        "computes the term but drops it (a dangling '+' "
                        "statement, reference AiR/train.py:332-340), so "
                        "parity means not applying it.")
    p.add_argument("--eval_repeat_num", type=int, default=10)
    p.add_argument("--min_length", type=int, default=1)
    p.add_argument("--max_length", type=int, default=16)
    p.add_argument("--ablate_attention_info", type=str2bool, default=False)
    p.add_argument("--supervised_save", type=str2bool, default=True)
    p.add_argument("--coco_split", type=str, default="split1")
    p.add_argument("--checkpoint", type=str, default="",
                   help="torch resnet50 state dict to warm-start the "
                        "backbone (optional)")
    p.add_argument("--evaluation_dir", type=str, default="",
                   help="log dir holding checkpoints/ for test.py")
    # hardware / runtime (new in this framework)
    p.add_argument("--mesh_size", type=int, default=0,
                   help="total mesh size (0 = all devices)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel factor: weight-shards every "
                        "conv/dense kernel row-parallel (along its "
                        "input-channel contraction dim) over a second "
                        "'model' mesh axis; must divide the device "
                        "count.  1 = pure data parallelism")
    p.add_argument("--tp_impl", type=str, default="gather",
                   choices=("gather", "shardmap"),
                   help="how --model_parallel training computes: "
                        "'gather' = params sharded at rest, all-"
                        "gathered at step entry (ZeRO-3 style; robust "
                        "to the XLA partitioner scan miscompile, "
                        "tools/tp_repro.py); 'shardmap' = true row-"
                        "parallel compute with hand-written psum "
                        "collectives on the heavy decode kernels "
                        "(train/tp_step.py)")
    p.add_argument("--half_precision", type=str2bool, default=False,
                   help="bf16 compute dtype for the model (params stay "
                        "f32); the TPU MXU path")
    p.add_argument("--stem_impl", type=str, default="conv",
                   choices=("conv", "s2d"),
                   help="backbone stem implementation: 'conv' = the "
                        "pixel-space 7x7/s2 convolution; 's2d' = the "
                        "exact space-to-depth reformulation (same "
                        "parameters/checkpoints, fewer idle MXU lanes "
                        "on the 3-channel input)")
    p.add_argument("--remat", type=remat_mode, default="scan_policy",
                   help="rematerialization mode for backprop: a bool "
                        "(false=none, true=all) or one of none/all/"
                        "backbone/scan/scan_policy/policy.  Default "
                        "'scan_policy' checkpoints the decode-scan "
                        "body while SAVING the ConvLSTM gate pre-"
                        "activations (~99%% of per-step FLOPs): the "
                        "r5-measured best at EVERY batch (89.3 img/s "
                        "at b32, beats no-remat's 88.3; runs b64 at "
                        "85.3 where no-remat OOMs) at a ~0.1%%-FLOP "
                        "recompute bill, grad-identical "
                        "(tests/test_remat.py); 'policy' adds "
                        "backbone checkpointing "
                        "(models/scanpath_model.py, docs/PERF.md)")
    p.add_argument("--device_eval", type=str2bool, default=False,
                   help="compute the validation/test metric suite with "
                        "the device kernels (metrics/device_eval.py) "
                        "instead of the host Python loops — same "
                        "aggregation semantics, removes the CPU metric "
                        "sweep from the eval hot path")
    p.add_argument("--ckpt_backend", type=str, default="msgpack",
                   choices=("msgpack", "orbax"),
                   help="checkpoint serialization backend: single-file "
                        "flax msgpack (sync, default) or orbax with "
                        "async saves that overlap the next train steps; "
                        "restore paths auto-detect the backend, so "
                        "resume/test work on runs from either")
    p.add_argument("--cache_images", type=str2bool, default=True)
    p.add_argument("--packed_cache_dir", type=str, default="",
                   help="if set, build/serve an on-disk packed uint8 "
                        "memmap of the resized images (bit-identical "
                        "loads, zero decode cost across runs)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="device batches to stage ahead of the training "
                        "loop (0 = synchronous)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="if set, capture a jax.profiler trace of a few "
                        "training steps into this directory")
    p.add_argument("--embed", type=int, default=512,
                   help="decoder feature width (512 = reference)")
    p.add_argument("--backbone_layers", type=str, default="3,4,6,3",
                   help="blocks per ResNet stage; 3,4,6,3 = ResNet-50 "
                        "(smaller values give thin models for smoke "
                        "drives)")
    # serving (cli/predict.py — new in this framework; the reference
    # has no inference-on-arbitrary-images path)
    p.add_argument("--predict_images", type=str, default="",
                   help="comma-separated image files, or one directory, "
                        "to predict scanpaths for")
    p.add_argument("--decode", type=str, default="greedy",
                   choices=("greedy", "sample"),
                   help="deterministic argmax decode or stochastic "
                        "sampling")
    p.add_argument("--num_samples", type=int, default=1,
                   help="scanpaths per image in --decode sample mode "
                        "(0 = use --eval_repeat_num, the evaluation "
                        "setting)")
    p.add_argument("--predict_att", type=str, default="",
                   help="comma-separated .npy attention maps aligned "
                        "with --predict_images (air/coco; zeros when "
                        "omitted)")
    p.add_argument("--target_category", type=str, default="",
                   help="COCO search target category name (one for all "
                        "images, or comma-separated per image)")
    p.add_argument("--predict_out", type=str, default="",
                   help="output JSON path ('' = stdout)")
    p.add_argument("--bundle", type=str, default="",
                   help="serve from an exported AOT bundle directory "
                        "(serve.jaxexport + manifest.json) instead of "
                        "rebuilding the model from --evaluation_dir; "
                        "decode mode/samples/geometry come from the "
                        "bundle manifest")
    # AOT export (cli/export.py — new in this framework; serialized
    # StableHLO serving bundles via jax.export)
    p.add_argument("--export_dir", type=str, default="",
                   help="output directory for the exported serving "
                        "bundle (serve.jaxexport + manifest.json)")
    p.add_argument("--export_batch", type=str, default="1",
                   help="serving batch size baked into the artifact: "
                        "an int, or 'sym' for a symbolic (any-size) "
                        "batch dimension")
    p.add_argument("--export_platforms", type=str, default="",
                   help="comma-separated lowering platforms; '' = "
                        "'cpu,tpu' (a backend-portable artifact)")
    p.add_argument("--export_check", type=str2bool, default=True,
                   help="after writing, deserialize the bundle and "
                        "verify it against the live model on random "
                        "inputs")
    # config files
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--set_cfgs", dest="set_cfgs", default=[], nargs="+")
    return p


def parse_opt(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)

    # yaml / set_cfgs layer (reference opts.py:52-66)
    cfg: dict = {}
    if args.cfg is not None:
        cfg = load_yaml_with_base(args.cfg)
    if args.set_cfgs:
        cfg = merge_set_cfgs(cfg, args.set_cfgs)
    for k, v in cfg.items():
        if not hasattr(args, k):
            print(f"Warning: key {k} not in args")
        setattr(args, k, v)
    # explicit CLI flags win over yaml (re-parse onto the namespace)
    args = parser.parse_args(argv, namespace=args)

    # per-task defaults for flags left unset
    defaults = TASK_DEFAULTS[args.task]
    if args.seed is None:
        args.seed = defaults["seed"]
    if args.weight_decay is None:
        args.weight_decay = defaults["weight_decay"]
    if args.img_dir is None:
        args.img_dir = defaults["img_dir"]
    if args.fix_dir is None:
        args.fix_dir = defaults["fix_dir"]
    return args
