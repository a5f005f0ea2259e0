"""Whole runs on the CPU at tiny sizes: the program agrees with the plain
reference on every cell's path, a broken timed path makes ``correct`` come
out false, and the control fails the limits the cells keep."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import control
from portbench.harness import manifest, runner
from portbench.tests import tiny

CELLS = ["uc2-finetune", "m3p-finetune", "uc2-eval", "m3p-eval", "uc2-serve"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(str(tmp_path_factory.mktemp("tiny")))


def run(root, cell, seed=2**31 + 7, trace=False):
    return runner.run_cell(root, cell + "-tiny", seed, 0.5, trace, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(root, cell):
    res = run(root, cell)
    assert res["correct"], res["checks"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device",
                         "checks"]
    c = manifest.cell(root, cell + "-tiny")
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(c.limits)


@pytest.mark.parametrize("cell,names", [
    ("m3p-finetune", {"data_wait_ms.train", "host_issue_ms.train", "mfu.train"}),
    # the host-paced cell keeps its rate per layer, beside its peak memory
    ("uc2-finetune", {"train_qa_per_s.host_paced"})])
def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(root, cell, names):
    res = run(root, cell, trace=True)
    assert res["correct"]
    assert names <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] > 0 for n in names)
    # no device on the CPU: nothing to read from the trace
    assert "attn_roofline.train" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged_state(monkeypatch):
    from clg_vqa_tpu_torch.train import loop
    make = loop.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def s(state, batch, seed, bank=None):
            keep = [p.detach().clone() for p in state.model.parameters()]
            _, m = step(state, batch, seed, bank)
            with torch.no_grad():
                for p, k0 in zip(state.model.parameters(), keep):
                    p.copy_(k0)
            return state, m
        return s
    monkeypatch.setattr(loop, "make_train_step", broken)


def _half_batch(monkeypatch):
    from clg_vqa_tpu_torch.train import loop
    make = loop.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def s(state, batch, seed, bank=None):
            n = next(iter(batch.values())).shape[1] // 2
            return step(state, {k: v[:, :n] for k, v in batch.items()}, seed, bank)
        return s
    monkeypatch.setattr(loop, "make_train_step", broken)


def _altered_eval_answer(monkeypatch):
    from clg_vqa_tpu_torch.eval import runner as ev
    make = ev.make_predict_step

    def broken(model, **k):
        step = make(model, **k)

        def s(batch):
            pred = step(batch).clone()
            pred[0] = (pred[0] + 1) % model.cfg.num_labels
            return pred
        return s
    monkeypatch.setattr(ev, "make_predict_step", broken)


def _altered_served_answer(monkeypatch):
    from clg_vqa_tpu_torch.eval.predictor import Predictor
    step = Predictor._step

    def broken(self, *a):
        pred, conf = step(self, *a)
        pred = pred.clone()
        pred[0] = (pred[0] + 1) % self.model.cfg.num_labels
        return pred, conf
    monkeypatch.setattr(Predictor, "_step", broken)


@pytest.mark.parametrize("cell,fault", [
    ("uc2-finetune", _unchanged_state), ("uc2-finetune", _half_batch),
    ("m3p-finetune", _unchanged_state), ("m3p-finetune", _half_batch),
    ("uc2-eval", _altered_eval_answer), ("m3p-eval", _altered_eval_answer),
    ("uc2-serve", _altered_served_answer)],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run(root, cell)["correct"]


# the number that the control fails at the cells' own size (PERF.md); the
# card test (test_portbench_cuda.py) holds it to the limits there
SEPARATES = {"uc2-finetune": "grad_diff", "m3p-finetune": "grad_diff",
             "uc2-eval": "answer_gap", "m3p-eval": "answer_gap",
             "uc2-serve": "confidence_gap"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_farther_from_the_reference_than_the_program(root, cell):
    limits = manifest.cell(root, cell + "-tiny").limits
    r = control.readings(root, cell + "-tiny", 2**31 + 11, 0.5, "cpu")
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    k = SEPARATES[cell]
    assert r["control"][k] > 2 * r["program"][k], r


def test_the_command_refuses_without_a_card_or_without_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would start")
    here = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "uc2-finetune", "--seed", "1", "--seconds", "1"],
                          cwd=tiny.ROOT, capture_output=True, text=True)
    assert here.returncode != 0 and here.stdout == ""
    bare = tmp_path / "bare"
    import shutil
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"), bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), bare)
    alone = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            "uc2-finetune", "--seed", "1", "--seconds", "1"],
                           cwd=bare, capture_output=True, text=True)
    assert alone.returncode != 0 and alone.stdout == ""
    assert json.loads((bare / "BENCHMARK.json").read_text())["workloads"]
