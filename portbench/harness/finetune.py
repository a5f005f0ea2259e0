"""Fine-tuning traffic: the recipe's train step (train/loop.make_train_step
over the device bank, AdamW with the clip) fed by data/pipeline.TrainPipeline.

Set-up builds the one training state, drives it through ``check_steps``
steps (the steps the reference follows) and ``warm_steps`` more, and hands
it to the window. The window runs steps back to back until ``--seconds``
have passed, then synchronises: the rate is the QA of every step over the
whole window."""
from __future__ import annotations

import sys
import time

import torch

from ..reference import data as ref_data
from ..reference.precision import FP32, fp32_products
from ..reference.train import train_steps
from . import checks, program, world as world_mod
from . import weights as W
from .seeds import sub
from .trace import profiled, reduce

E2E = "train_qa_per_s"


def step_seed(seed: int, i: int) -> int:
    return sub(seed, f"step{i}", 64)


def horizon(t: dict) -> tuple[int, int]:
    """(warmup, total) steps of the recipe's schedule: sized by
    ``schedule_epochs`` epochs of GQA's training questions, warmup its
    ``warmup_proportion``."""
    total = t["gqa_train_qa"] // (t["acc"] * t["mbs"]) * t["schedule_epochs"]
    return int(t["warmup_proportion"] * total), total


def lr(t: dict):
    """The learning rate after ``count`` completed updates of a run that
    starts right after the warmup (WarmupLinearSchedule's decay)."""
    warmup, total = horizon(t)
    return lambda count: t["lr"] * max(0.0, (total - warmup - count) / (total - warmup))


def recipe(t: dict) -> dict:
    return {"adam_b1": t["adam_b1"], "adam_b2": t["adam_b2"],
            "adam_eps": t["adam_eps"], "weight_decay": t["weight_decay"],
            "clip": t["clip"], "lambda": t["semantic_lambda"], "top_k": t["top_k"]}


class Feed:
    """The pipeline's batches across epochs."""

    def __init__(self, pipe):
        self.pipe, self.n = pipe, 0
        self.it = pipe.epoch(0)

    def next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.n += 1
            self.it = self.pipe.epoch(self.n)
            return next(self.it)

    def close(self):
        self.it.close()


class State:
    pass


def setup(run) -> State:
    from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
    from clg_vqa_tpu_torch.train.loop import TrainState, make_train_step
    from clg_vqa_tpu_torch.train.optim import make_optimizer, warmup_linear_schedule
    t, d, st = run.cell.traffic, run.d, State()
    st.world = world_mod.make(d, t, run.seed, t["qa"], device=run.device,
                              labels=True)
    world_mod.write_store(st.world, run.tmp)
    store = program.reader(st.world)
    ds = program.dataset(st.world, range(t["qa"]), d, store,
                         program.tokenizer(d))
    st.bank = program.bank(store, d, run.device)
    model = run.model()
    warmup, total = horizon(t)
    sched = warmup_linear_schedule(t["lr"], warmup, total)
    params = dict(model.named_parameters())
    opt = make_optimizer(list(params), lambda c: sched(warmup + c),
                         b1=t["adam_b1"], b2=t["adam_b2"], eps=t["adam_eps"],
                         weight_decay=t["weight_decay"], clip_norm=t["clip"])
    st.state = TrainState(model, opt.init(params), 0)
    D = W.make_distance(d["labels"], sub(run.seed, "prior"), run.device)
    st.step = make_train_step(
        opt, D, semantic_lambda=t["semantic_lambda"], top_k=t["top_k"],
        compute_dtype=program.dtype(t["compute_dtype"]),
        fused_attn=t["fused_attn"])
    st.feed = Feed(TrainPipeline(ds, micro_batch_size=t["mbs"],
                                 grad_acc_steps=t["acc"],
                                 seed=sub(run.seed, "order", 31),
                                 device=run.device, with_features=False))
    st.i = 0
    # the check steps: what the reference follows
    p0 = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    st.prog = {"loss": [], "ids": []}
    for s in range(t["check_steps"]):
        b = st.feed.next()
        st.prog["ids"].append(b["input_ids"].cpu())
        m = run_step(run, st, b)
        st.prog["loss"].append(m["loss"].item())
        if s == 0:
            mu = st.state.opt_state.mu
            st.prog["g1"] = {k: (v / (1 - t["adam_b1"])).to("cpu", copy=True)
                             for k, v in mu.items()}
            st.prog["grad"] = {k: g.norm().item() for k, g in st.prog["g1"].items()}
    st.prog["change"] = {k: (p.detach() - p0[k].to(p.device)).norm().item()
                         for k, p in params.items()}
    del p0, params
    for _ in range(t["warm_steps"]):
        run_step(run, st, st.feed.next())
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return st


def run_step(run, st, batch):
    st.state, m = st.step(st.state, batch, seed=step_seed(run.seed, st.i),
                          bank=st.bank.tensors())
    st.i += 1
    return m


def window(run, st) -> dict:
    t = run.cell.traffic
    wait = issue = 0.0
    n = 0
    epoch0 = st.feed.n
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        b = st.feed.next()
        c = time.perf_counter()
        run_step(run, st, b)
        e = time.perf_counter()
        wait += c - a
        issue += e - c
        n += 1
        if e - t0 >= run.seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    qa = n * t["acc"] * t["mbs"]
    print(f"finetune: {n} steps in {dt:.3f} s; a step {1e3 * wait / n:.3f} ms "
          f"waiting for data, {1e3 * issue / n:.3f} ms issuing; epochs begun "
          f"in the window {st.feed.n - epoch0}", file=sys.stderr)
    return {"metrics": {E2E: qa / dt}, "attempted": qa, "failed": 0,
            "seconds": dt, "qa": qa,
            "data_wait_s": wait / n, "issue_s": issue / n}


def traced(run, st):
    n = run.cell.traffic["trace_steps"]
    with profiled() as box:
        for _ in range(n):
            with torch.profiler.record_function("pipeline.next"):
                b = st.feed.next()
            with torch.profiler.record_function("train_step"):
                run_step(run, st, b)
    return reduce(box[0], n)


def release(st) -> None:
    st.feed.close()
    del st.state, st.step, st.bank, st.feed


def reference_inputs(run, st) -> dict:
    """The check steps' microbatches worked out again from the raw data:
    each row of the program's feed is identified by its question's first
    words, and its tokens, regions and label are the reference's own."""
    t, d, world = run.cell.traffic, run.d, st.world
    key = {tuple(ref_data.piece_id(w, d["vocab"]) for w in q.split()[:3]): r
           for r, q in enumerate(world.questions)}
    steps, unmatched = [], 0
    for ids in st.prog["ids"]:
        mbs = []
        for a in range(ids.shape[0]):
            rows = []
            for row in ids[a].tolist():
                r = key.get(tuple(row[1:4]))
                if r is None or ref_data.tokens(world.questions[r], d["vocab"],
                                                d["text"])[0] != row:
                    unmatched += 1
                    r = 0 if r is None else r
                rows.append(r)
            mbs.append(ref_data.batch(world, rows, d, run.device))
        steps.append(mbs)
    return {"steps": steps, "unmatched": unmatched,
            "seeds": [step_seed(run.seed, s) for s in range(len(steps))],
            "w0": run.weights(),
            "D": W.make_distance(d["labels"], sub(run.seed, "prior"), run.device)}


def reference(run, inputs: dict, prec=FP32, rows: float = 1.0) -> dict:
    t = run.cell.traffic
    with fp32_products():
        return train_steps(run.family.reference, run.cell.config, inputs["w0"],
                           inputs["steps"], inputs["seeds"], inputs["D"], lr=lr(t),
                           recipe=recipe(t), prec=prec, rows=rows, keep_grad=True)


FAULT = "half_batch"


def judge(run, st, prec=None, fault=None) -> dict:
    """The numbers compared: the program's check steps against the fp32
    reference's. With ``prec`` (the control) or ``fault`` (``half_batch``:
    half of each microbatch left out, the mean taken over the rest) the
    reference in that precision, or with that fault, stands in the
    program's place."""
    if not hasattr(st, "ref"):
        st.inputs = reference_inputs(run, st)
        st.ref = reference(run, st.inputs)
    prog = st.prog
    if prec is not None or fault is not None:
        prog = reference(run, st.inputs, prec=prec or FP32,
                         rows=0.5 if fault == FAULT else 1.0)
    out = checks.train_readings(prog, st.ref)
    out["rows_unmatched"] = float(st.inputs["unmatched"])
    return out
