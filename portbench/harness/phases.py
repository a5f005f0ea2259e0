"""The device's idle time inside each traced unit, split by the program's
own phases.

The program marks its host phases with ``utils/profiling.span`` and keeps
their records (``span_records()``: name, parent, unit, start and end on
``time.perf_counter_ns``). The k-th unit's top-level record (``train.step``,
``eval.pass``) opens microseconds after the k-th benchmark span of that
unit (``train_step``, ``run_eval``) and lasts as long, so the offset of
their starts puts the unit's records on the trace's clock. Each idle gap of
the device that ``Trace.breakdown`` gives to the unit's span is cut where
the program's records open and close: each piece goes to the innermost
record open over it, or to the top-level record's name where none is."""
from __future__ import annotations

import bisect
import dataclasses

from .trace import _union

# kind -> (the benchmark's span of a unit, the program's top-level span)
UNITS = {"finetune": ("train_step", "train.step"),
         "eval": ("run_eval", "eval.pass")}
MAX_ANCHOR_ERROR = 0.01     # of a unit's duration


@dataclasses.dataclass
class Split:
    idle_s: dict            # phase -> idle seconds, summed over the units
    units: int
    anchor_error: float     # the largest |duration difference| / duration


def program_records() -> list | None:
    """The program's span records, or None where the program keeps none."""
    from clg_vqa_tpu_torch.utils import profiling
    read = getattr(profiling, "span_records", None)
    return None if read is None else read()


def split(tr, records, unit_span: str, top: str) -> Split | None:
    """The idle gaps of ``tr`` that begin in ``unit_span``, cut by the
    program's phases; None without device operations, or where the
    top-level records and the benchmark's unit spans differ in number or
    anchor worse than ``MAX_ANCHOR_ERROR``."""
    if tr is None or not tr.ops or not records:
        return None
    spans = sorted((s, e) for n, s, e in tr.spans if n == unit_span)
    tops = sorted((r for r in records if r.parent is None and r.name == top),
                  key=lambda r: r.start_ns)
    if not spans or len(spans) != len(tops):
        return None
    placed, worst = [], 0.0
    for (s, e), t in zip(spans, tops):
        off = s - t.start_ns * 1e-3
        err = abs((t.end_ns - t.start_ns) * 1e-3 - (e - s)) / (e - s)
        if err > MAX_ANCHOR_ERROR:
            return None
        worst = max(worst, err)
        placed += [(r.start_ns * 1e-3 + off, r.end_ns * 1e-3 + off, r.name)
                   for r in records if r.unit == t.unit]
    cuts, names = _innermost(placed)
    idle: dict[str, float] = {}
    at = tr.start
    for s, e in _union(tr.ops) + [(tr.end, tr.end)]:
        if s > at and tr.span_at(at) == unit_span:
            for a, b, name in _pieces(at, s, cuts, names):
                idle[name or top] = idle.get(name or top, 0.0) + (b - a) * 1e-6
        at = max(at, e)
    return Split(idle, len(spans), worst)


def _innermost(placed):
    """The times where the innermost open record changes, and after each
    the name of that record (None where none is open)."""
    cuts = sorted({t for s, e, _ in placed for t in (s, e)})
    names = []
    for t in cuts:
        open_ = [(s, -e, n) for s, e, n in placed if s <= t < e]
        names.append(max(open_)[2] if open_ else None)
    return cuts, names


def _pieces(a, b, cuts, names):
    """[a, b) cut at ``cuts``: (start, end, innermost name) each."""
    i = bisect.bisect_right(cuts, a) - 1
    while a < b:
        nxt = cuts[i + 1] if i + 1 < len(cuts) else b
        end = min(b, nxt)
        yield a, end, names[i] if i >= 0 else None
        a, i = end, i + 1


def idle_ms(ctx, phase: str) -> float | None:
    """Device-idle ms a traced unit while ``phase`` was the innermost span
    open, in the gaps the breakdown gives to the unit; None where the trace
    has no device operations or the program keeps no records that
    anchor."""
    if not hasattr(ctx, "phase_split"):
        unit = UNITS.get(ctx.kind)
        ctx.phase_split = None if unit is None else split(
            ctx.trace, program_records(), *unit)
    sp = ctx.phase_split
    return None if sp is None else 1e3 * sp.idle_s.get(phase, 0.0) / sp.units
