"""The program's spans in the traced stretch: the `mbt.*` ranges that
mpi_bicgstab_tpu_torch/utils/timing.py records while a profiler runs,
read from the host-and-card profile of the stretch (the Chrome trace
tracing.Profiler writes for it), on the clock of the card's operations.

`read(events)` returns the spans inside the stretch and the card's idle
time there, split exactly, interval by interval, by the innermost
program span open on the host at each instant. The idle time is the
stretch less the card's operations merged: the timeline from which
tracing.read takes busy_s. Two shares of it are per-layer metrics:

  launch  the innermost span is a kernel wrapper's `mbt.launch.*`
          (checks, allocations, the launch)
  loop    the host is inside an `mbt.iter` and in no `mbt.launch.*`: the
          solver loop's own tensor operations, Python and reads

`of_run(record)` finds the trace a run's stretch wrote and reads it once
for all the readers of the run. A program without spans (one older than
them) gives spans but no `mbt.*` among them, and its readers report
nothing.

    python3 -m perfbench.spans perfbench/traces/<cell>.1.json

prints the breakdown of one trace: the idle seconds by innermost span
and the count of each span.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from collections import Counter, defaultdict
from pathlib import Path

from perfbench import tracing

PREFIX = "mbt."
LAUNCH = "mbt.launch."
ITER = "mbt.iter"
SYNC = "mbt.sync"
OUTSIDE = "outside program spans"
# a span is a RecordFunction: torch's C++ range records a `cpu_op`,
# torch.profiler.record_function a `user_annotation`
SPAN_CATS = {"cpu_op", "user_annotation"}


@dataclasses.dataclass
class Spans:
    spans: list             # (name, start_us, end_us) inside the stretch
    idle_s: float           # the card's idle time in the stretch
    idle_by_span: dict      # innermost span (or OUTSIDE) -> idle seconds
    idle_launch_s: float    # idle with an mbt.launch.* innermost
    idle_loop_s: float      # idle in an mbt.iter, in no mbt.launch.*

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)


def _stretch(events):
    """(t0, t1) of the stretch's mark, or None without one."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == tracing.MARK \
                and (e.get("cat") or "").lower() == "user_annotation":
            t0 = float(e["ts"])
            return t0, t0 + float(e["dur"])
    return None


def _idle(events, t0, t1) -> list:
    """The stretch less the card's operations, merged and clipped as
    tracing.read merges them for busy_s: sorted (start, end) in us."""
    busy = tracing._merge(
        (max(s, t0), min(s + d, t1))
        for e in events if e.get("ph") == "X"
        and (e.get("cat") or "").lower() in tracing.DEVICE_CATS
        for s, d in [(float(e["ts"]), float(e.get("dur", 0.0)))]
        if s < t1 and s + d > t0)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def read(events: list) -> Spans | None:
    """The program's spans and the split of the card's idle time in the
    stretch of a host-and-card trace; None without the stretch's mark."""
    ab = _stretch(events)
    if ab is None:
        return None
    t0, t1 = ab
    spans = sorted(((e["name"], float(e["ts"]),
                     float(e["ts"]) + float(e.get("dur", 0.0)))
                    for e in events if e.get("ph") == "X"
                    and (e.get("cat") or "").lower() in SPAN_CATS
                    and e.get("name", "").startswith(PREFIX)
                    and t0 <= float(e["ts"]) < t1),
                   key=lambda s: (s[1], -s[2]))
    # span edges in time order, ends before starts at one instant
    marks = sorted([(s, 1, i) for i, (_, s, e) in enumerate(spans) if e > s]
                   + [(e, 0, i) for i, (_, s, e) in enumerate(spans)
                      if e > s])
    by = defaultdict(float)
    launch = loop = 0.0
    open_, j = [], 0
    for a, b in _idle(events, t0, t1):
        cur = a
        while cur < b:
            while j < len(marks) and marks[j][0] <= cur:
                t, start, i = marks[j]
                if start:
                    open_.append(i)
                elif i in open_:
                    open_.remove(i)
                j += 1
            nxt = min(b, marks[j][0]) if j < len(marks) else b
            d = (nxt - cur) * 1e-6
            names = [spans[i][0] for i in open_]
            inner = names[-1] if names else OUTSIDE
            by[inner] += d
            if inner.startswith(LAUNCH):
                launch += d
            elif ITER in names and not any(n.startswith(LAUNCH)
                                           for n in names):
                loop += d
            cur = nxt
    return Spans(spans=spans, idle_s=sum(by.values()), idle_by_span=dict(by),
                 idle_launch_s=launch, idle_loop_s=loop)


_READ = {}


def of_run(run) -> Spans | None:
    """The spans of a run's host-and-card stretch: the newest host trace
    under the harness's trace directory, if it reduces to the run's
    `trace_host` (else None: the trace is another run's)."""
    from perfbench import harness
    th = run.trace_host
    files = sorted(Path(harness.TRACE_DIR).glob("*.1.json"),
                   key=lambda p: p.stat().st_mtime_ns)
    if th is None or not files:
        return None
    path = files[-1]
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _READ:
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        _READ.clear()
        _READ[key] = (tracing.read(events), read(events))
    trace, spans = _READ[key]
    return spans if trace == th else None


def main(argv=None) -> int:
    path = Path((argv or sys.argv[1:])[0])
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    sp = read(events)
    if sp is None:
        print(f"{path}: no traced stretch")
        return 1
    counts = Counter(n for n, _, _ in sp.spans)
    print(json.dumps({
        "idle_s": sp.idle_s, "idle_launch_s": sp.idle_launch_s,
        "idle_loop_s": sp.idle_loop_s,
        "idle_by_span": sorted(sp.idle_by_span.items(),
                               key=lambda kv: -kv[1]),
        "spans": dict(counts.most_common())}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
