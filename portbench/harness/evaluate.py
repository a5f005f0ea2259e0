"""Zero-shot eval traffic: eval/runner.run_eval over test-dev-sized passes,
one language after another, as users run xGQA.

The window runs whole passes until ``--seconds`` have passed; the rate is
the questions answered (their predictions on the host) over the whole
window. The check compares a sample of the window's answers, drawn from the
seed, with the reference's logits."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import data as ref_data
from ..reference.precision import FP32, fp32_products
from . import checks, program, world as world_mod
from .seeds import sub
from .trace import profiled, reduce

E2E = "eval_qa_per_s"
BLOCK = 256             # reference rows at a time


class State:
    pass


def setup(run) -> State:
    t, d, st = run.cell.traffic, run.d, State()
    langs, q = t["languages"], t["questions_per_pass"]
    st.world = world_mod.make(d, t, run.seed, len(langs) * q, device=run.device,
                              labels=False, words=[f"{x}_" for x in langs])
    world_mod.write_store(st.world, run.tmp)
    store = program.reader(st.world)
    tok = program.tokenizer(d)
    st.sets = [program.dataset(st.world, range(i * q, (i + 1) * q), d, store, tok)
               for i in range(len(langs))]
    st.bank = program.bank(store, d, run.device)
    st.model = run.model()
    st.labels = program.label_names(d)
    st.passes = 0
    for _ in range(t["warm_passes"]):
        one_pass(run, st)
    return st


def one_pass(run, st) -> dict:
    from clg_vqa_tpu_torch.eval.runner import run_eval
    t = run.cell.traffic
    lang = st.passes % len(st.sets)
    st.passes += 1
    res = run_eval(st.model, st.sets[lang], st.labels,
                   batch_size=t["batch_size"],
                   compute_dtype=program.dtype(t["compute_dtype"]),
                   device_bank=st.bank, fused_attn=t["fused_attn"])
    return res


def window(run, st) -> dict:
    q = run.cell.traffic["questions_per_pass"]
    st.answers = {}             # QA row -> answer index
    failed = n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        base = ((st.passes) % len(st.sets)) * q
        res = one_pass(run, st)
        n += q
        got = {int(r["questionId"]): r["prediction"] for r in res["results"]}
        for row in range(base, base + q):
            p = got.get(row)
            if p is None or not p.startswith("a"):
                failed += 1
                continue
            st.answers[(n // q, row)] = int(p[1:])
    dt = time.perf_counter() - t0
    answered = n - failed
    return {"metrics": {E2E: answered / dt}, "attempted": n, "failed": failed,
            "seconds": dt, "qa": answered}


def traced(run, st):
    n = run.cell.traffic["trace_passes"]
    with profiled() as box:
        for _ in range(n):
            with torch.profiler.record_function("run_eval"):
                one_pass(run, st)
    return reduce(box[0], n)


def release(st) -> None:
    del st.model, st.bank, st.sets


def checked(run, st):
    """(QA rows, answers [N], None): a sample of the window's answers drawn
    from the seed."""
    keys = sorted(st.answers)
    rng = np.random.default_rng(sub(run.seed, "check"))
    n = min(run.cell.traffic["check_answers"], len(keys))
    keys = [keys[i] for i in sorted(rng.choice(len(keys), n, replace=False))]
    return [r for _, r in keys], torch.tensor([st.answers[k] for k in keys]), None


def reference_logits(run, world, rows, prec=FP32) -> torch.Tensor:
    w0 = run.weights()
    out = []
    with torch.no_grad(), fp32_products():
        for s in range(0, len(rows), BLOCK):
            b = ref_data.batch(world, rows[s:s + BLOCK], run.d, run.device)
            out.append(run.family.reference.forward(run.cell.config, w0, b,
                                                    prec=prec))
    return torch.cat(out)


FAULT = "altered_answer"


def judge_answers(run, st, rows, answer, conf=None, prec=None, fault=None) -> dict:
    """The answer numbers of the answers (and confidences) given to QA rows
    ``rows``, against the reference's logits of those rows. With ``prec``
    (the control) the reference's answers in that precision stand in the
    program's; with ``fault`` (``altered_answer``) the first answer is
    changed where it is produced."""
    if not rows:
        return {}
    if not hasattr(st, "ref"):
        st.ref = reference_logits(run, st.world, rows)
    ref = st.ref
    answer = answer.to(ref.device)
    conf = None if conf is None else conf.to(ref.device)
    if prec is not None:
        ctl = reference_logits(run, st.world, rows, prec=prec)
        answer = ctl.argmax(-1)
        conf = None if conf is None else torch.softmax(ctl, -1).max(-1).values
    if fault == FAULT:
        answer = answer.clone()
        answer[0] = (answer[0] + 1) % ref.shape[1]
    return checks.answer_readings(ref, answer, conf)


def judge(run, st, prec=None, fault=None) -> dict:
    return judge_answers(run, st, *checked(run, st), prec=prec, fault=fault)
