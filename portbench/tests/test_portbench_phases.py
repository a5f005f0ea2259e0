"""The split of a traced unit's idle device time by the program's own spans
(harness/phases.py): on a synthetic trace, on the real clocks of a
profiled run, and through a whole traced run of a tiny cell."""
import time
import types

import pytest
import torch

from clg_vqa_tpu_torch.utils import profiling
from clg_vqa_tpu_torch.utils.profiling import SpanRecord, span
from portbench.harness import evaluate, finetune, manifest, phases, runner
from portbench.harness.trace import Trace, profiled, reduce
from portbench.tests import tiny

TRAIN = ("forward", "backward", "accumulate", "clip", "optimizer")
EVAL = ("assemble", "dispatch", "consume")
OFFSET_NS = 5_000_000_000           # the program's clock against the trace's


def _rec(name, parent, unit, s, e):
    return SpanRecord(name, parent, unit, int(s * 1e3) + OFFSET_NS,
                      int(e * 1e3) + OFFSET_NS)


def _synthetic():
    """Two steps, times in us on the trace's clock."""
    spans = [("pipeline.next", 0, 10), ("train_step", 10, 110),
             ("pipeline.next", 110, 120), ("train_step", 120, 220)]
    top = "train.step"
    recs = [_rec(top, None, 1, 10, 110),
            _rec("train.forward", top, 1, 12, 40),
            _rec("train.backward", top, 1, 40, 70),
            _rec("train.accumulate", top, 1, 70, 80),
            _rec("train.clip", top, 1, 80, 90),
            _rec("train.optimizer", top, 1, 90, 108),
            _rec(top, None, 2, 120, 220),
            _rec("train.forward", top, 2, 121, 150),
            _rec("train.backward", top, 2, 150, 200),
            _rec("train.clip", top, 2, 200, 210),
            _rec("train.optimizer", top, 2, 210, 219)]
    ops = [(f"k{i}", s, e) for i, (s, e) in enumerate(
        [(0, 5), (7, 11), (15, 30), (45, 60), (72, 75), (95, 100), (111, 125),
         (160, 170), (205, 206), (221, 230)])]
    return Trace(ops, spans, 2, 0, 230), recs


def test_gaps_land_on_the_innermost_phase_and_add_up_to_the_units_idle():
    tr, recs = _synthetic()
    sp = phases.split(tr, recs, "train_step", "train.step")
    # each gap is cut where the phases open and close: [11, 15) gives 1 to
    # the step before its forward opens and 3 to the forward; [100, 111)
    # gives 8 to the optimizer and 3 to the step (2 after the optimizer, 1
    # after the step's record, in pipeline.next); [206, 221) 2 to the step
    want = {"train.step": 1 + 3 + 2, "train.forward": 3 + 10 + 25,
            "train.backward": 5 + 10 + 10 + 30, "train.accumulate": 2 + 5,
            "train.clip": 10 + 5 + 4, "train.optimizer": 5 + 8 + 9}
    assert sp.units == 2 and sp.anchor_error == 0
    assert sp.idle_s == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert sum(sp.idle_s.values()) == pytest.approx(gaps["train_step"])
    assert gaps["pipeline.next"] == pytest.approx(2e-6)


def test_no_split_where_the_units_do_not_anchor():
    tr, recs = _synthetic()
    assert phases.split(tr, recs[:6], "train_step", "train.step") is None
    stretched = list(recs)
    stretched[6] = _rec("train.step", None, 2, 120, 223)    # 3% longer
    assert phases.split(tr, stretched, "train_step", "train.step") is None
    no_ops = Trace([], tr.spans, 2, 0, 230)
    assert phases.split(no_ops, recs, "train_step", "train.step") is None


def _ctx(tr, kind="finetune"):
    return types.SimpleNamespace(kind=kind, trace=tr)


def test_the_readers_read_per_unit_ms_and_nothing_from_a_program_without_records(
        monkeypatch):
    tr, recs = _synthetic()
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    assert phases.idle_ms(_ctx(tr), "train.forward") == pytest.approx(0.019)
    assert phases.idle_ms(_ctx(tr), "train.accumulate") == pytest.approx(0.0035)
    assert phases.idle_ms(_ctx(tr, "serve"), "train.forward") is None
    monkeypatch.delattr(profiling, "span_records")      # the parent's program
    assert phases.idle_ms(_ctx(tr), "train.forward") is None


def _fake_step():
    with span("train.step"):
        for name in TRAIN:
            with span("train." + name):
                time.sleep(0.01)


def test_real_clocks_anchor_within_the_limit():
    """The benchmark's spans and the program's records of one profiled run:
    their starts' offset is each unit's, their durations agree."""
    span("x.off")
    with profiled() as box:
        for _ in range(3):
            with torch.profiler.record_function("pipeline.next"):
                time.sleep(0.001)
            with torch.profiler.record_function("train_step"):
                _fake_step()
    tr = reduce(box[0], 3)
    assert not tr.ops                       # the CPU: no device operations
    ops = [("k", t, t + 20.0) for t in range(int(tr.start), int(tr.end), 100)]
    tr = Trace(ops, tr.spans, 3, tr.start, tr.end)
    sp = phases.split(tr, profiling.span_records(), "train_step", "train.step")
    assert sp is not None and sp.units == 3 and sp.anchor_error < 0.01
    assert {"train." + n for n in TRAIN} <= set(sp.idle_s)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert sum(sp.idle_s.values()) == pytest.approx(gaps["train_step"])
    # each 10-ms phase holds about a fifth of a step's idle time
    for n in TRAIN:
        assert sp.idle_s["train." + n] == pytest.approx(
            gaps["train_step"] / 5, rel=0.2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell,names", [("m3p-finetune", TRAIN), ("uc2-eval", EVAL),
                                        ("m3p-eval", EVAL)])
def test_a_traced_tiny_run_reports_no_phase_metric_on_the_cpu(root, cell, names):
    res = runner.run_cell(root, cell + "-tiny", 2**31 + 7, 0.5, True, device="cpu")
    assert res["correct"]
    kind = "train" if cell.endswith("finetune") else "eval"
    assert not {f"{n}_idle_ms.{kind}" for n in names} & set(res["metrics"])


@pytest.mark.parametrize("cell,names", [("m3p-finetune", TRAIN), ("uc2-eval", EVAL),
                                        ("m3p-eval", EVAL)])
def test_a_traced_tiny_run_with_device_ops_reports_the_phases(root, cell, names,
                                                              monkeypatch):
    """A tiny cell with a device op laid every 100 us over its traced
    window: the phases' ms a unit add up to no more than the breakdown's
    idle a unit in the benchmark's span of a unit, and to most of it."""
    def with_ops(prof, units):
        tr = reduce(prof, units)
        ops = [("k", t, t + 20.0) for t in range(int(tr.start), int(tr.end), 100)]
        return Trace(ops, tr.spans, units, tr.start, tr.end)
    kind = "train" if cell.endswith("finetune") else "eval"
    monkeypatch.setattr(finetune if kind == "train" else evaluate, "reduce",
                        with_ops)
    res = runner.run_cell(root, cell + "-tiny", 2**31 + 7, 0.5, True, device="cpu")
    got = [res["metrics"][f"{n}_idle_ms.{kind}"]["value"] for n in names]
    unit = {"train": ("train_step", "trace_steps"),
            "eval": ("run_eval", "trace_passes")}[kind]
    n = manifest.cell(root, cell + "-tiny").traffic[unit[1]]
    unit_idle_ms = 1e3 * dict(res["breakdown"]["idle_gaps"])[unit[0]] / n
    assert all(v > 0 for v in got)
    assert 0.9 * unit_idle_ms <= sum(got) <= unit_idle_ms * (1 + 1e-9)
