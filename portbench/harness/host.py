"""What the host did around a window, printed on standard error beside the
result (no metric reads it): the process's CPU seconds, the machine's
steal seconds (time the hypervisor gave its cores to others), the
process's involuntary context switches, and a fixed pure-Python workload
timed after the window. Host-paced cells follow the host's speed; these
readings say whether a slow run had a slow host."""
from __future__ import annotations

import os
import resource
import time

PROBE_N = 300_000


def _steal_s() -> float | None:
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        return int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def sample() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "cpu": time.process_time(),
            "steal": _steal_s(), "nivcsw": ru.ru_nivcsw}


def probe_ms() -> float:
    """The least of three timings of a fixed pure-Python loop, in ms."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(PROBE_N):
            acc = (acc + i * i) % 1_000_003
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def report(a: dict, b: dict) -> str:
    wall = b["wall"] - a["wall"]
    steal = ("n/a" if a["steal"] is None or b["steal"] is None
             else f"{b['steal'] - a['steal']:.2f}")
    return (f"host: window {wall:.2f} s, process cpu {b['cpu'] - a['cpu']:.2f} s, "
            f"steal {steal} s (all cores), involuntary switches "
            f"{b['nivcsw'] - a['nivcsw']}, probe {probe_ms():.2f} ms, "
            f"cores {len(os.sched_getaffinity(0))}, load {os.getloadavg()[0]:.2f}")
