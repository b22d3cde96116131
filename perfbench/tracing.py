"""The traced stretch of a --trace 1 run: torch.profiler over a short
steady stretch of the solver loop, written as a Chrome trace under
perfbench/traces/ as soon as the profiler stops (a profiler exported
after another has run loses its device events), and read back into what
the per-layer readers use: the device's operations, its busy time, and
its idle gaps named by what the host was doing in them.

Recording the host's operations slows a host-bound loop by half or more
and recording the card's alone by a third, so the busy time and kernel
times come from a profile of the card alone (CUDA; the stretch is then
the span of its events) and the names of the idle gaps from a second
profile of the same stretch that records the host too (CPU and CUDA,
the stretch marked by an annotation)."""
from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from pathlib import Path

MARK = "perfbench.traced_stretch"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function"}
TOP = 10
LOOK_BACK = 64


@dataclasses.dataclass
class Trace:
    window_s: float          # the traced stretch (its mark, or its events)
    busy_s: float            # device time inside it (union of operations)
    device: list             # (name, start_us, dur_us) inside the stretch
    idle_by_host: dict       # host operation -> seconds the device idled

    def device_ops(self) -> list:
        """The TOP device operations by time: [name, seconds]."""
        ops = defaultdict(float)
        for name, _, dur in self.device:
            ops[name] += dur * 1e-6
        return [[k, v] for k, v in
                sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """The TOP host operations by the device's idle time in them."""
        return [[k, v] for k, v in sorted(self.idle_by_host.items(),
                                          key=lambda kv: -kv[1])[:TOP]]


class Profiler:
    """start() before the traced stretch, stop() after it, which writes
    the trace to `path` (with no path, nothing is written: card_busy()
    reads the card's time from memory). host=False records the card's
    activity alone."""

    def __init__(self, host: bool, path: Path | None):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.path = path
        # without a card (the CPU rehearsal) the host is all there is
        on_card = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] if host or not on_card else []
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark = torch.profiler.record_function(MARK)

    def start(self):
        self._prof.start()
        self._mark.__enter__()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.path))

    def card_busy(self) -> tuple[float, int]:
        """(seconds, operations) of the card in the stopped profile: the
        union of its operations' spans, read from the profiler's events
        in memory, so that a profile of a whole window writes nothing."""
        from torch.autograd import DeviceType
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in self._prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        return busy_ns(spans) * 1e-9, len(spans)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(spans) -> float:
    """The length of the union of (start, end) spans."""
    return sum(b - a for a, b in _merge(spans))


def _host_at(t, starts, host):
    """The innermost host operation running at t: the latest-starting one
    that covers it, among the LOOK_BACK that start last before it."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - LOOK_BACK, -1), -1):
        name, s, e = host[j]
        if e >= t and name != MARK:
            return name
    return "host code between traced operations"


def read(events: list) -> Trace | None:
    """Reduce Chrome trace events. The stretch is the span of its mark,
    or without one the span of all its timed events; None without any."""
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    marks = [e for e in timed if e.get("name") == MARK
             and (e.get("cat") or "").lower() == "user_annotation"]
    if marks:
        t0 = float(marks[0]["ts"])
        t1 = t0 + float(marks[0]["dur"])
    elif timed:
        t0 = min(float(e["ts"]) for e in timed)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
    else:
        return None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = (e.get("cat") or "").lower()
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS and s < t1 and s + d > t0:
            device.append((e["name"], s, d))
        elif cat in HOST_CATS:
            host.append((e["name"], s, s + d))
    busy = _merge((max(s, t0), min(s + d, t1)) for _, s, d in device)
    busy_us = sum(b - a for a, b in busy)
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = defaultdict(float)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle[_host_at(0.5 * (a + b), starts, host)] += (b - a) * 1e-6
    return Trace(window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
                 device=device, idle_by_host=dict(idle))


def load(path: Path) -> Trace | None:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return read(events)
