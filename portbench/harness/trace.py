"""A short traced sub-window of a run, reduced to device operations, the
benchmark's own spans, busy and idle time, and the breakdown.

The benchmark opens one ``record_function`` span around each call it makes
into the program (``pipeline.next``, ``train_step``, ``run_eval``,
``predict_batch``) and around its own wait for the next arrival
(``arrival_wait``); an idle gap of the device is named by the span open on
the host when it began."""
from __future__ import annotations

import contextlib
import dataclasses

import torch

SPANS = ("pipeline.next", "train_step", "run_eval", "predict_batch",
         "arrival_wait")


@dataclasses.dataclass
class Trace:
    ops: list               # (name, start_us, end_us) of every device operation
    spans: list             # (name, start_us, end_us) of the benchmark's spans
    units: int              # steps, passes or calls traced
    start: float            # the traced window, us
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self) -> list:
        """The device operations that are kernels (not copies or fills)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.ops)) * 1e-6

    def time_s(self, names) -> float:
        """Seconds of the kernels whose names contain any of ``names``."""
        return sum(e - s for n, s, e in self.kernels()
                   if any(k in n for k in names)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        gaps: dict[str, float] = {}
        at = self.start
        for s, e in _union(self.ops) + [(self.end, self.end)]:
            if s > at:
                name = self.span_at(at)
                gaps[name] = gaps.get(name, 0.0) + (s - at) * 1e-6
            at = max(at, e)
        order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], t] for n, t in order],
                "idle_gaps": [[n, t] for n, t in
                              sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}

    def span_at(self, t: float) -> str:
        """The innermost benchmark span open at ``t``."""
        open_ = [(s, n) for n, s, e in self.spans if s <= t < e]
        return max(open_)[1] if open_ else "between spans"


def _union(intervals) -> list:
    out = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


@contextlib.contextmanager
def profiled():
    """Profile the block (host and device); yields a list that receives
    the profiler once the block has ended."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    box = []
    with torch.profiler.profile(activities=acts) as prof:
        yield box
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    box.append(prof)


def reduce(prof, units: int) -> Trace:
    """The Trace of a finished profiler over ``units`` traced units."""
    ops, spans = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name in SPANS or getattr(e, "is_user_annotation", False):
            if e.device_type == torch.autograd.DeviceType.CPU and e.name in SPANS:
                spans.append((e.name, s, t))
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((e.name.replace("(anonymous namespace)::", ""), s, t))
    if not spans:
        raise RuntimeError("the profiler recorded none of the benchmark's spans")
    start = min(s for _, s, _ in spans)
    end = max([e for _, _, e in spans] + [e for _, _, e in ops])
    return Trace(ops, spans, units, start, end)
