"""CLI: python -m clg_vqa_tpu_torch.cli {train,eval,score,convert} ...

The port of clg_vqa_tpu/cli/__main__.py:23-146 with its flags and printed
lines, plus ``--device`` (default ``cuda``; ``cpu`` for the tests). It
mirrors the reference entry points train_task.py, eval_task.py,
scripts/GQA_score.py and conversions/. The prune, sft, extract and
convert-store commands are not ported yet (ROADMAP.md §A slices 5, 10 and
11).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from . import common as C


def cmd_train(args):
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
    train_ds = C.build_dataset(
        args, cfg, task_cfg, task_cfg.train_split, feat_train,
        annotations_jsonpath=args.train_annotations_jsonpath,
        code_mixer=code_mixer)
    val_ds = C.build_dataset(
        args, cfg, task_cfg, task_cfg.val_split, feat_val,
        annotations_jsonpath=args.val_annotations_jsonpath)
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
    best = runner.finetune(resume=args.resume)
    print(f"Best validation score: {100*best:.3f}")


def cmd_eval(args):
    from ..data.gqa import load_answer_vocab
    from ..eval.runner import run_eval

    cfg, task_cfg, _ = C.build_configs(args)
    model = C.build_model(args, cfg)
    feat = args.features_path or task_cfg.features_path_train
    ds = C.build_dataset(args, cfg, task_cfg, args.split, feat,
                         annotations_jsonpath=args.annotations_jsonpath)
    _, label2ans = load_answer_vocab(task_cfg.dataroot)
    bank = C.maybe_device_bank(ds, cfg, task_cfg, device=args.device)
    out = f"{args.output_dir}/{args.split}_result.json"
    res = run_eval(model, ds, label2ans, batch_size=task_cfg.eval_batch_size,
                   compute_dtype=None if args.fp32 else torch.bfloat16,
                   out_path=out, device_bank=bank)
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="clg_vqa_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("train")
    C.add_common_args(sp)
    C.add_train_args(sp)
    sp.set_defaults(fn=cmd_train)

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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
