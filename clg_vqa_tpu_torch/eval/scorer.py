"""GQA exact-match scorer (own copy of clg_vqa_tpu/eval/scorer.py; parity
with volta/scripts/GQA_score.py:6-20).

Predictions: list of {"questionId", "prediction"} records.
Truth: GQA-format dict {qid: {"answer": ...}}. Questions absent from the
truth dict are skipped (not counted), as in the reference.
"""
from __future__ import annotations

import json


def evaluate(preds_list: list[dict], truth_dict: dict) -> float:
    # qids are matched as strings on both sides (json truth keys are str)
    truth = {str(k): v for k, v in truth_dict.items()}
    score, count = 0.0, 0
    for entry in preds_list:
        rec = truth.get(str(entry["questionId"]))
        if rec is None:
            continue
        if entry["prediction"] == rec["answer"]:
            score += 1.0
        count += 1
    if count == 0:
        # the reference dies on the same input (ZeroDivisionError,
        # GQA_score.py:20); a mismatched truth file must not print 0%
        raise ValueError(
            "no prediction questionId matched the truth file — wrong "
            "--truth_file or disjoint splits?")
    return score / count


def evaluate_files(preds_file: str, truth_file: str) -> float:
    with open(preds_file) as f:
        preds = json.load(f)
    with open(truth_file) as f:
        truth = json.load(f)
    return evaluate(preds, truth)


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--preds_file", required=True)
    p.add_argument("--truth_file", required=True)
    args = p.parse_args()
    print(100 * evaluate_files(args.preds_file, args.truth_file))


if __name__ == "__main__":
    main()
