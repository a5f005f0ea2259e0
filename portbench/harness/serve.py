"""Serving traffic: eval/predictor.Predictor.predict_batch offered calls at
a fixed rate.

Calls are due evenly spaced at ``rate_calls_per_s``; one caller makes them
in order, each as soon as it is due and the previous one has returned,
until the window closes. Offered above what the Predictor sustains, the
caller is never idle: the rate is the requests answered (answers on the
host) over the time from the window's start to the last call's return,
all the work and all the time. A call's service time runs from its start
to its return; its latency from when it was due to its return, which
grows with the backlog and means something only below capacity."""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import evaluate, program, world as world_mod
from .seeds import sub
from .trace import profiled, reduce

E2E = "serve_req_per_s"


class State:
    pass


def setup(run) -> State:
    from clg_vqa_tpu_torch.eval.predictor import Predictor
    t, d, st = run.cell.traffic, run.d, State()
    rng = np.random.default_rng(sub(run.seed, "calls"))
    sizes = world_mod.spread(*t["requests_per_call"], t["calls"], rng)
    st.offsets = np.concatenate([[0], np.cumsum(sizes)])
    st.world = world_mod.make(d, t, run.seed, int(st.offsets[-1]),
                              device=run.device, labels=False)
    world_mod.write_store(st.world, run.tmp)
    st.model = run.model()
    st.pred = Predictor(st.model, program.reader(st.world), program.tokenizer(d),
                        program.label_names(d), max_seq_length=d["text"],
                        max_region_num=d["regions"],
                        batch_capacity=t["batch_capacity"],
                        compute_dtype=program.dtype(t["compute_dtype"]))
    st.k = 0
    for _ in range(t["warm_calls"]):
        call(st)
    return st


def call(st) -> tuple[int, list]:
    """Make the next call of the pool; (its index, its answers)."""
    k = st.k % (len(st.offsets) - 1)
    st.k += 1
    rows = range(st.offsets[k], st.offsets[k + 1])
    reqs = [(st.world.questions[r], str(st.world.image_of[r])) for r in rows]
    return k, st.pred.predict_batch(reqs)


def offered(run, st, n_calls: int | None, spans: bool = False) -> list:
    """Calls due every 1 / rate seconds from now, made until ``run.seconds``
    have passed (or ``n_calls`` of them): [(latency s, call index, answers,
    service s)]."""
    period = 1.0 / run.cell.traffic["rate_calls_per_s"]
    out = []
    t0 = time.perf_counter()
    close = t0 + run.seconds
    j = 0
    while True:
        due = t0 + j * period
        if n_calls is None and (due >= close or time.perf_counter() >= close):
            break
        if j == n_calls:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            if spans:
                with torch.profiler.record_function("arrival_wait"):
                    time.sleep(wait)
            else:
                time.sleep(wait)
        start = time.perf_counter()
        if spans:
            with torch.profiler.record_function("predict_batch"):
                k, ans = call(st)
        else:
            k, ans = call(st)
        done = time.perf_counter()
        out.append((done - due, k, ans, done - start))
        j += 1
    return out


def window(run, st) -> dict:
    t0 = time.perf_counter()
    st.calls = offered(run, st, None)
    dt = time.perf_counter() - t0
    lat = np.array([c[0] for c in st.calls]) * 1e3
    svc = np.array([c[3] for c in st.calls]) * 1e3
    n = sum(len(c[2]) for c in st.calls)
    print(f"serve: {len(st.calls)} calls ({n} requests) in {dt:.3f} s, offered "
          f"at {run.cell.traffic['rate_calls_per_s']} calls/s; service ms "
          f"median {np.median(svc):.3f}, p95 {np.percentile(svc, 95):.3f}, "
          f"max {svc.max():.3f}; latency from due ms median "
          f"{np.median(lat):.3f}, p95 {np.percentile(lat, 95):.3f}",
          file=sys.stderr)
    return {"metrics": {E2E: n / dt,
                        "serve_p95_ms": float(np.percentile(lat, 95))},
            "attempted": n, "failed": 0, "seconds": dt, "qa": n,
            "call_p95_ms": float(np.percentile(svc, 95))}


def traced(run, st):
    n = run.cell.traffic["trace_calls"]
    with profiled() as box:
        offered(run, st, n, spans=True)
    return reduce(box[0], n)


def release(st) -> None:
    del st.pred, st.model


def checked(run, st):
    """(rows, answers [N], confidences [N]) of a sample of the window's
    requests drawn from the seed."""
    reqs = [(r, a) for _, k, ans, _ in st.calls
            for r, a in zip(range(st.offsets[k], st.offsets[k + 1]), ans)]
    rng = np.random.default_rng(sub(run.seed, "check"))
    n = min(run.cell.traffic["check_requests"], len(reqs))
    pick = [reqs[i] for i in sorted(rng.choice(len(reqs), n, replace=False))]
    return ([r for r, _ in pick],
            torch.tensor([int(a["answer"][1:]) for _, a in pick]),
            torch.tensor([a["confidence"] for _, a in pick]))


FAULT = evaluate.FAULT


def judge(run, st, prec=None, fault=None) -> dict:
    return evaluate.judge_answers(run, st, *checked(run, st), prec=prec,
                                  fault=fault)
