"""The port's host spans (utils/profiling.span) on the CPU: off without a
profiler, nested records with their parent and unit under one, and the
phases the train step and the eval runner mark."""
import json
import types

import numpy as np
import pytest
import torch

from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.data.synthetic import eval_world
from clg_vqa_tpu_torch.eval.runner import run_eval
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.tools.profile_eval import device_kernels
from clg_vqa_tpu_torch.train import loop, optim
from clg_vqa_tpu_torch.utils import profiling
from clg_vqa_tpu_torch.utils.profiling import span, span_records

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, v_feature_size=16, num_locs=7,
            pooler_size=32, clf_hidden_size=32, num_labels=8)


def _shape(records):
    return [(r.name, r.parent, r.unit) for r in sorted(records,
                                                       key=lambda r: r.start_ns)]


def test_a_span_without_a_profiler_records_nothing():
    before = span_records()
    with span("x.outer") as s:
        with span("x.inner"):
            out = sum(range(10))
    assert out == 45 and s is None
    assert span_records() == before
    # nothing is allocated a call: every span off is the same object
    assert span("x.a") is span("x.b")


def _nested():
    with span("t.step"):
        with span("t.a"):
            with span("t.b"):
                pass
        with span("t.c"):
            pass
    with span("t.step"):
        pass


@pytest.mark.parametrize("how", ["profile", "trace"])
def test_spans_nest_under_a_profiler(how, tmp_path):
    span("x.off")                           # a profiler session starts anew
    if how == "profile":
        with torch.profiler.profile() as prof:
            _nested()
    else:
        with profiling.trace(str(tmp_path)) as prof:
            _nested()
        names = {e["name"] for e in json.loads(
            (tmp_path / "trace.json").read_text())["traceEvents"]}
        assert {"t.step", "t.a", "t.b", "t.c"} <= names
    recs = span_records()
    assert _shape(recs) == [("t.step", None, 1), ("t.a", "t.step", 1),
                            ("t.b", "t.a", 1), ("t.c", "t.step", 1),
                            ("t.step", None, 2)]
    by = {(r.name, r.unit): r for r in recs}
    outer, a, b, c = (by[("t.step", 1)], by[("t.a", 1)], by[("t.b", 1)],
                      by[("t.c", 1)])
    assert outer.start_ns <= a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert a.end_ns <= c.start_ns <= c.end_ns <= outer.end_ns
    assert by[("t.step", 2)].start_ns >= outer.end_ns
    # each span is a record_function range in the profiler's own events
    ranges = [e.name for e in prof.events() if e.name.startswith("t.")]
    assert sorted(ranges) == sorted(r.name for r in recs)
    # reading does not clear; the next session replaces them
    assert span_records() == recs
    span("x.off")
    with torch.profiler.profile():
        with span("t.other"):
            pass
    assert _shape(span_records()) == [("t.other", None, 1)]


def test_an_exception_in_a_span_propagates_and_closes_it():
    span("x.off")
    with torch.profiler.profile():
        with pytest.raises(KeyError, match="boom"):
            with span("t.step"):
                with span("t.fails"):
                    raise KeyError("boom")
        with span("t.after"):
            pass
    assert _shape(span_records()) == [("t.step", None, 1),
                                      ("t.fails", "t.step", 1),
                                      ("t.after", None, 2)]


def test_the_profile_tools_count_no_span_as_a_kernel():
    """On the card each span's range also lies on the device's timeline, as
    a user annotation over its kernels; tools/profile_train.py and
    profile_eval.py take their kernels from device_kernels, which leaves
    the annotation out."""
    span("x.off")
    with torch.profiler.profile() as prof:
        with span("train.step"):
            with span("eval.pass"):
                torch.ones(4, 4) @ torch.ones(4, 4)
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler's own events, each laid on the card's timeline
    events = [types.SimpleNamespace(name=e.name, device_type=cuda,
                                    is_user_annotation=e.is_user_annotation)
              for e in prof.events()]
    assert {"train.step", "eval.pass", "aten::mm"} <= {e.name for e in events}
    names = {e.name for e in device_kernels(events)}
    assert "aten::mm" in names
    assert not {n for n in names if n.startswith(("train.", "eval."))}
    assert device_kernels(prof.events()) == []     # host events are no kernels


def _train(profiled: bool):
    torch.manual_seed(0)
    model = UC2(UC2Config(**TINY), device="cpu", seed=0)
    params = dict(model.named_parameters())
    opt = optim.make_optimizer(list(params), 1e-3)
    state = loop.TrainState(model, opt.init(params), 0)
    step = loop.make_train_step(opt, torch.rand(8, 8, generator=torch.Generator()
                                                .manual_seed(0)),
                                semantic_lambda=1.0, top_k=4, compute_dtype=None)
    r = np.random.RandomState(0)
    acc, mbs, T, R = 2, 4, 6, 4
    batch = {"input_ids": r.randint(3, 64, (acc, mbs, T)).astype(np.int32),
             "input_mask": np.ones((acc, mbs, T), np.int32),
             "features": r.randn(acc, mbs, R, 16).astype(np.float32),
             "locs": r.rand(acc, mbs, R, 7).astype(np.float32),
             "image_mask": np.ones((acc, mbs, R), np.int32),
             "labels": r.randint(0, 8, (acc, mbs)).astype(np.int32)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    span("x.off")
    if profiled:
        with torch.profiler.profile():
            state, m = step(state, batch, seed=3)
    else:
        state, m = step(state, batch, seed=3)
    return m, model.state_dict()


def test_the_train_step_marks_its_phases():
    m, params = _train(profiled=True)
    step = "train.step"
    assert _shape(span_records()) == [
        (step, None, 1), ("train.accumulate", step, 1),
        ("train.forward", step, 1), ("train.backward", step, 1),
        ("train.accumulate", step, 1),
        ("train.forward", step, 1), ("train.backward", step, 1),
        ("train.accumulate", step, 1),
        ("train.clip", step, 1), ("train.optimizer", step, 1)]
    recs = sorted(span_records(), key=lambda r: r.start_ns)
    for a, b in zip(recs[1:], recs[2:]):
        assert a.end_ns <= b.start_ns           # the phases do not overlap
    # the spans change nothing the step computes
    m0, params0 = _train(profiled=False)
    assert all(torch.equal(m[k], m0[k]) for k in m0)
    assert all(torch.equal(v, params0[k]) for k, v in params.items())


def test_run_eval_marks_its_phases_for_each_batch(tmp_path):
    w = eval_world(str(tmp_path), 10, num_labels=5, vocab_size=64, n_images=4,
                   device="cpu")
    model = UC2(UC2Config(**dict(TINY, v_feature_size=2048, num_labels=5)),
                device="cpu", seed=0)
    kw = dict(batch_size=4, compute_dtype=None, device_bank=w.bank, depth=1)
    span("x.off")
    with torch.profiler.profile():
        got = run_eval(model, w.dataset, w.label2ans, **kw)
    recs = span_records()
    assert _shape(recs)[0] == ("eval.pass", None, 1)
    assert {(r.parent, r.unit) for r in recs[:-1]} == {("eval.pass", 1)}
    names = [n for n, _, _ in _shape(recs)[1:]]
    # 3 batches: each assembled, dispatched and consumed (the last assemble
    # finds the batches spent), one batch in flight behind the newest
    assert names == ["eval.assemble", "eval.dispatch",
                     "eval.assemble", "eval.dispatch", "eval.consume",
                     "eval.assemble", "eval.dispatch", "eval.consume",
                     "eval.assemble", "eval.consume"]
    want = run_eval(model, w.dataset, w.label2ans, **kw)
    assert got["results"] == want["results"] and got["n"] == 10
