"""CLI: python -m clg_vqa_tpu_torch.cli
{train,prune,sft,eval,score,convert,extract,convert-store} ...

The port of clg_vqa_tpu/cli/__main__.py with its flags and printed lines,
plus ``--device`` (default ``cuda``; ``cpu`` for the tests). It mirrors the
reference entry points train_task.py, train_task_prunning.py (``prune``,
IMP rounds), train_task_sft.py (``sft``, from a ``--mask_file``),
eval_task.py, scripts/GQA_score.py, conversions/ and features_extraction/
(``extract``: ``--detector c4``, the R101-C4 36-box detector behind UC2's
features, or ``--detector x101``, the X101-FPN 100-box detector behind
M3P's) and the store converters (``convert-store``: h5, per-image LMDB,
mmf npy directories, QA-joined td-lmdb and CFS). Feature stores are CFS
files, per-image feature LMDBs, or QA-joined td-lmdbs, which ``train`` and
``eval`` ingest once into a CFS store under the output directory.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from . import common as C


def _train_like(args, mode: str):
    """train, prune or sft: one assembly of model, data and runner, then
    the mode's recipe."""
    from ..data.gqa import load_answer_vocab
    from ..data.pipeline import TrainPipeline
    from ..train.driver import FinetuneRunner

    cfg, task_cfg, optim_cfg = C.build_configs(args)
    # command.txt: argv + resolved configs (train_task.py:190-193 parity)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "command.txt"), "w") as f:
        print(vars(args), file=f)
        print("", file=f)
        print(cfg, file=f)
        print(task_cfg, file=f)
        print(optim_cfg, file=f)
    model = C.build_model(args, cfg)
    if task_cfg.embed_clf:
        ans2label, _ = load_answer_vocab(task_cfg.dataroot)
        C.init_classifier_from_answers(model, C.build_tokenizer(args, cfg),
                                       ans2label)
        print(f"embed_clf: classifier initialized from word embeddings of "
              f"{len(ans2label)} answers")
    code_mixer = C.build_code_mixer(task_cfg, args.seed)
    feat_train = args.features_path or task_cfg.features_path_train
    feat_val = task_cfg.features_path_val or feat_train
    # the reference's primary train artifact is a QA-joined tensorpack LMDB
    # (format: serialized_lmdb); ingest it once into the native store
    train_items = val_items = None
    if C.is_tdlmdb(feat_train):
        feat_train, train_items = C.ingest_tdlmdb(feat_train, args.output_dir,
                                                  "train")
    if C.is_tdlmdb(feat_val):
        feat_val, val_items = C.ingest_tdlmdb(feat_val, args.output_dir, "val")
    train_ds = C.build_dataset(
        args, cfg, task_cfg, task_cfg.train_split, feat_train,
        annotations_jsonpath=args.train_annotations_jsonpath,
        code_mixer=code_mixer, entry_items=train_items)
    val_ds = C.build_dataset(
        args, cfg, task_cfg, task_cfg.val_split, feat_val,
        annotations_jsonpath=args.val_annotations_jsonpath,
        entry_items=val_items)
    if (task_cfg.batch_size % optim_cfg.grad_acc_steps
            or task_cfg.batch_size < optim_cfg.grad_acc_steps):
        raise SystemExit(
            f"batch_size {task_cfg.batch_size} must be a positive multiple "
            f"of --grad_acc_steps {optim_cfg.grad_acc_steps} (silent "
            f"truncation would change the effective batch)")
    micro_bs = task_cfg.batch_size // optim_cfg.grad_acc_steps
    # the train store on the device when it fits: batches then carry only
    # token ids and store indices
    train_bank = None if args.no_train_bank else C.maybe_device_bank(
        train_ds, cfg, task_cfg, budget_bytes=4 << 30, device=args.device)
    if train_bank is not None:
        print(f"train feature bank resident on {args.device} "
              f"({train_bank.nbytes / 1e6:.0f} MB)")
    pipe = TrainPipeline(train_ds, micro_batch_size=micro_bs,
                         grad_acc_steps=optim_cfg.grad_acc_steps,
                         seed=args.seed, device=args.device,
                         with_features=train_bank is None)
    D = C.build_distance_matrix(task_cfg, task_cfg.num_labels)
    runner = FinetuneRunner(
        model, pipe, val_ds, D, task_cfg=task_cfg, optim_cfg=optim_cfg,
        output_dir=args.output_dir,
        compute_dtype=None if args.fp32 else torch.bfloat16, seed=args.seed,
        train_bank=train_bank, save_every=args.save_every,
        mid_save=args.mid_save, fused_attn=args.fused_attn,
        model_name=C.model_name(cfg))
    if mode == "train":
        best = runner.finetune(resume=args.resume)
        print(f"Best validation score: {100*best:.3f}")
    elif mode == "prune":
        res = runner.imp_prune(fraction=args.prune_fraction,
                               resume=args.resume)
        print(f"IMP best epoch {res['best_epoch']} "
              f"score {100*res['best_score']:.3f}; history: {res['history']}")
    elif mode == "sft":
        best = runner.sft(args.mask_file, resume=args.resume)
        print(f"SFT best validation score: {100*best:.3f}")


def cmd_eval(args):
    from ..data.gqa import load_answer_vocab
    from ..eval.runner import run_eval

    cfg, task_cfg, _ = C.build_configs(args)
    model = C.build_model(args, cfg)
    feat = args.features_path or task_cfg.features_path_train
    # eval over the QA-joined td-lmdb artifact ingests it as train does
    items = None
    if C.is_tdlmdb(feat):
        feat, items = C.ingest_tdlmdb(feat, args.output_dir, args.split)
    ds = C.build_dataset(args, cfg, task_cfg, args.split, feat,
                         annotations_jsonpath=args.annotations_jsonpath,
                         entry_items=items)
    _, label2ans = load_answer_vocab(task_cfg.dataroot)
    bank = C.maybe_device_bank(ds, cfg, task_cfg, device=args.device)
    out = f"{args.output_dir}/{args.split}_result.json"
    res = run_eval(model, ds, label2ans, batch_size=task_cfg.eval_batch_size,
                   compute_dtype=None if args.fp32 else torch.bfloat16,
                   out_path=out, split=args.split, device_bank=bank)
    acc = (f", accuracy {100*res['accuracy']:.2f}"
           if res["accuracy"] is not None else "")
    print(f"wrote {out}: {res['n']} predictions at "
          f"{res['qa_per_sec']:.0f} QA/s{acc}")


def cmd_score(args):
    from ..eval.scorer import evaluate_files
    print(100 * evaluate_files(args.preds_file, args.truth_file))


def cmd_convert(args):
    """A torch checkpoint -> a params dir of this package (the conversions/
    equivalent)."""
    from ..train import checkpoints as ckpt
    cfg, _, _ = C.build_configs(args)
    ckpt.save_params(args.output_dir, args.name,
                     C.load_pretrained(args.from_pretrained, cfg))
    print(f"saved {args.output_dir}/{args.name}")


def _load_detector_weights(path: str, kind: str) -> dict:
    """A detector's parameters as the port's tree, from a params directory
    of this package (a state dict saved by ``train/checkpoints.save_params``),
    a caffe ``.pkl`` (the VG R101-C4 release; ``kind`` "c4" only) or a torch
    ``.pth``/``.bin`` state dict (detectron2 names for "c4",
    vqa-maskrcnn-benchmark's for "x101")."""
    from ..train import checkpoints as ckpt
    from ..utils.convert_detector import (detectron2_c4_to_pytree, load_c4_params,
                                          maskrcnn_x101_to_pytree)
    if os.path.isdir(path):
        sd = ckpt.load_params(os.path.dirname(path) or ".", os.path.basename(path))
    elif path.endswith(".pkl"):
        if kind != "c4":
            raise ValueError(
                "caffe .pkl checkpoints are the VG R101-C4 format; "
                "--detector x101 loads the vqa-maskrcnn-benchmark .pth file")
        import pickle
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
    to_tree = detectron2_c4_to_pytree if kind == "c4" else maskrcnn_x101_to_pytree
    return load_c4_params(to_tree(sd))


def cmd_extract(args):
    """Offline region-feature extraction (the features_extraction/ stage):
    a directory of images -> a CFS store, through the R101-C4 36-box or the
    X101-FPN 100-box pipeline."""
    import glob as _glob

    from ..data.cfs import CfsWriter

    kw = {f: getattr(args, f) for f in ("short", "max_size", "pad_h", "pad_w",
                                        "num_boxes", "pre_nms_topk",
                                        "post_nms_topk") if getattr(args, f)}
    if args.detector == "c4":
        from ..models.detector.extractor import (Extractor36, ExtractorConfig,
                                                 init_extractor_params)
        params = (_load_detector_weights(args.weights, "c4") if args.weights
                  else init_extractor_params(torch.Generator().manual_seed(0)))
        ex = Extractor36(params, ExtractorConfig(**kw) if kw else None,
                         device=args.device)
    else:
        from ..models.detector.extractor_x101 import (ExtractorX101, X101Config,
                                                      init_x101_params)
        cfg = X101Config(**kw) if kw else None
        params = (_load_detector_weights(args.weights, "x101") if args.weights
                  else init_x101_params(torch.Generator().manual_seed(0), cfg))
        ex = ExtractorX101(params, cfg, device=args.device)
    paths = sorted(_glob.glob(os.path.join(args.images, "*")))

    def gen():
        # lazy loaders: the decode runs in extract_many's prefetch workers
        for p in paths:
            yield ((lambda p=p: _load_image_bgr(p)),
                   os.path.splitext(os.path.basename(p))[0])

    n = 0
    with CfsWriter(args.out) as w:
        # --limit counts extracted records: undecodable files are skipped
        # and take no slot
        for rec in ex.extract_many(gen(), device_batch=max(args.device_batch, 1)):
            w.add(rec)
            n += 1
            if args.limit and n >= args.limit:
                break
    print(f"extracted {n} images -> {args.out}")


def _load_image_bgr(path):
    """BGR uint8 image, or None for anything that does not decode (as
    cv2.imread): ``.npy`` loads directly, other files through PIL when it is
    installed (RGB, flipped to BGR)."""
    import numpy as np
    if path.endswith(".npy"):
        try:
            return np.load(path)
        except Exception:
            return None
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]
    except Exception:             # PIL absent, or not an image
        return None


def cmd_convert_store(args):
    """Feature-store conversion by the source's and the destination's kind
    (clg_vqa_tpu/cli/__main__.py:264-290): with ``--annotations``, an h5 or
    CFS store and a target pkl -> a QA-joined td-lmdb; else h5 <-> CFS, an
    mmf npy directory -> CFS, a td-lmdb -> CFS + an entries pkl
    (``--entries_out``, default ``<dst>_target.pkl``), a per-image LMDB ->
    CFS, and CFS -> a per-image LMDB."""
    from ..data import convert_store as cs
    from ..data import tdlmdb as td
    src, dst = args.src, args.dst
    if args.annotations:      # QA-joined td-lmdb production needs the targets
        if src.endswith(".h5"):
            n = td.h5_to_tdlmdb(src, args.annotations, dst)
        else:
            n = td.cfs_to_tdlmdb(src, args.annotations, dst)
        print(f"converted {n} QA records: {src} + {args.annotations} -> {dst}")
        return
    if src.endswith(".h5") and dst.endswith(".cfs"):
        n = cs.h5_to_cfs(src, dst)
    elif src.endswith(".cfs") and dst.endswith(".h5"):
        n = cs.cfs_to_h5(src, dst)
    elif dst.endswith(".cfs") and os.path.isdir(src) and \
            any(f.endswith(".npy") for f in os.listdir(src)):
        n = cs.npy_to_cfs(src, dst)
    elif dst.endswith(".cfs") and C.is_tdlmdb(src):
        entries_pkl = args.entries_out or dst[:-4] + "_target.pkl"
        n_img, n = td.tdlmdb_to_cfs(src, dst, entries_pkl)
        print(f"converted {n} QA records / {n_img} images: {src} -> {dst} "
              f"(+ {entries_pkl})")
        return
    elif dst.endswith(".cfs"):
        n = cs.lmdb_to_cfs(src, dst)
    else:
        n = cs.cfs_to_lmdb(src, dst)
    print(f"converted {n} records: {src} -> {dst}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="clg_vqa_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    for mode in ("train", "prune", "sft"):
        sp = sub.add_parser(mode)
        C.add_common_args(sp)
        C.add_train_args(sp)
        if mode == "prune":
            sp.add_argument("--prune_fraction", type=float, default=0.1)
        if mode == "sft":
            sp.add_argument("--mask_file", required=True)
        sp.set_defaults(fn=lambda a, m=mode: _train_like(a, m))

    sp = sub.add_parser("eval")
    C.add_common_args(sp)
    sp.add_argument("--split", default="test")
    sp.add_argument("--annotations_jsonpath", default="")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("score")
    sp.add_argument("--preds_file", required=True)
    sp.add_argument("--truth_file", required=True)
    sp.set_defaults(fn=cmd_score)

    sp = sub.add_parser("convert")
    C.add_common_args(sp)
    sp.add_argument("--name", default="params_pretrained")
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("extract")
    sp.add_argument("--images", required=True, help="directory of images")
    sp.add_argument("--out", required=True, help="output .cfs store")
    sp.add_argument("--detector", choices=("c4", "x101"), default="c4")
    sp.add_argument("--weights", default="",
                    help="params dir, caffe .pkl or torch .pth/.bin")
    sp.add_argument("--limit", type=int, default=0)
    sp.add_argument("--device_batch", type=int, default=1,
                    help="images per device batch (batched convs)")
    for f, hint in (("short", "resize short side (MIN_SIZE_TEST)"),
                    ("max_size", "long-side cap (MAX_SIZE_TEST)"),
                    ("pad_h", "padded device height"),
                    ("pad_w", "padded device width"),
                    ("num_boxes", "regions per image"),
                    ("pre_nms_topk", "RPN pre-NMS top-k"),
                    ("post_nms_topk", "RPN post-NMS top-k")):
        sp.add_argument(f"--{f}", type=int, default=0,
                        help=f"{hint}; 0 = detector default")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_extract)

    sp = sub.add_parser("convert-store")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--annotations", default="",
                    help="target pkl; triggers QA-joined td-lmdb output "
                         "(h5/cfs + targets -> tdlmdb)")
    sp.add_argument("--entries_out", default="",
                    help="entries pkl path for tdlmdb -> cfs ingest")
    sp.set_defaults(fn=cmd_convert_store)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
