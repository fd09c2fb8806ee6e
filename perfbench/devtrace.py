"""The window's device trace and the host's spans around it.

``Tracer`` records nothing when disabled: ``span`` is then a shared
no-op.  Enabled, ``start`` opens a ``torch.profiler`` session over CUDA
activity only (a model step launches ~10^5 kernels; host op events would
add several per launch), ``span(name)`` records the host's
``perf_counter_ns`` interval of each call into the program, and ``stop``
closes the session.  ``view(t0_ns, t1_ns)`` reduces the trace to the
window [t0, t1] on the host's clock.

How the trace is read (copied from ``chip_smoke.py``'s
``profile_device``, lines 1340-1460): a profiler session drops the first
milliseconds of device activity when the tracer has been idle, so a
throw-away session of marker kernels (``torch.cuda._sleep``, named
``spin_kernel``) runs just before the recorded one, which opens with
marker kernels too; a long marker closes it.  One short marker,
launched right after a synchronize, aligns the clocks: its device start
less the host time of its launch is the offset from the host's clock to
the trace's (off by the launch latency, some microseconds).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
import time

MARKER = "spin_kernel"
HEADS, HEAD_CYCLES = 8, 200_000          # ~0.1 ms each at 1.98 GHz
ALIGN_CYCLES = 20_000                    # ~10 us
TAIL_CYCLES = 4_000_000                  # ~2 ms
TAIL_MIN_NS = 1_500_000
PAD_S = 0.2                              # the session stays open past the
                                         # tail, so that its buffers flush
TOP = 10                                 # entries of each breakdown list


class Tracer:
    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.spans: list = []            # (name, start_ns, end_ns), host
        self._prof = None
        self._align_host_ns = None

    @contextlib.contextmanager
    def _record(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def span(self, name: str):
        """A context manager timing one host interval named ``name``."""
        return self._record(name) if self.enabled else _NULL

    def _spins(self, n: int, cycles: int) -> None:
        for _ in range(n):
            self.torch.cuda._sleep(cycles)

    def start(self) -> None:
        """Open the session (its set-up before the window's clock starts)."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            self._spins(HEADS, HEAD_CYCLES)
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._spins(HEADS, HEAD_CYCLES)
        torch.cuda.synchronize()
        self._align_host_ns = time.perf_counter_ns()
        torch.cuda._sleep(ALIGN_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        if not self.enabled:
            return
        torch = self.torch
        torch.cuda.synchronize()
        self._spins(1, TAIL_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        self._prof.__exit__(None, None, None)

    def view(self, t0_ns: int, t1_ns: int) -> "View":
        """The trace of the host window [t0_ns, t1_ns]."""
        from torch.autograd import DeviceType
        events = sorted(((e.name(), e.start_ns(), e.end_ns())
                         for e in self._prof.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA),
                        key=lambda e: e[1])
        markers = [i for i, e in enumerate(events) if MARKER in e[0]]
        tails = [i for i in markers
                 if events[i][2] - events[i][1] >= TAIL_MIN_NS]
        # a trace that lost its tail ends where it ends
        end = tails[0] if tails else len(events)
        # the align marker is the last one before the tail: the window
        # launches none
        before = [i for i in markers if i < end]
        if before:
            align = before[-1]
            offset = events[align][1] - self._align_host_ns
        else:
            # the start markers lost: align the window's first activity
            # with the window's start
            align = -1
            offset = (events[0][1] if events else 0) - t0_ns
        inside = [e for e in events[align + 1:end] if MARKER not in e[0]]
        lost = [k for k, gone in (("start", not before), ("end", not tails))
                if gone]
        if lost:
            print(f"perfbench: the profiler lost the window's {' and '.join(lost)}"
                  " marker; the trace is read as it stands", file=sys.stderr)
        return View(events=inside, spans=list(self.spans), offset_ns=offset,
                    t0_ns=t0_ns + offset, t1_ns=t1_ns + offset)


_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class View:
    """Device activities (name, start_ns, end_ns) on the trace's clock, the
    host's spans on the host's, and the window [t0_ns, t1_ns] on the
    trace's clock."""
    events: list
    spans: list
    offset_ns: int
    t0_ns: int
    t1_ns: int
    _starts: list = None
    _busy: list = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def clipped(self):
        """(name, start, end) of every activity, cut to the window."""
        for name, s, e in self.events:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                yield name, s, e

    def busy_intervals(self) -> list:
        """The union of the activities' intervals inside the window."""
        if self._busy is not None:
            return self._busy
        out = []
        for _, s, e in sorted(self.clipped(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        self._busy = out
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, patterns) -> float:
        """Device seconds of the activities whose lower-case name holds one
        of ``patterns``, inside the window."""
        return sum(e - s for name, s, e in self.clipped()
                   if any(p in name.lower() for p in patterns)) / 1e9

    def idle_gaps(self) -> list:
        """(start, end) of every gap between busy intervals inside the
        window, the window's ends included, on the trace's clock."""
        gaps, prev = [], self.t0_ns
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1_ns > prev:
            gaps.append((prev, self.t1_ns))
        return gaps

    def host_doing(self, t_trace_ns: int) -> str:
        """The host span open at a trace-clock instant (the spans follow
        one another), or ``harness``: the benchmark's own loop between
        calls into the program."""
        if self._starts is None:
            self.spans.sort(key=lambda sp: sp[1])
            self._starts = [sp[1] for sp in self.spans]
        t = t_trace_ns - self.offset_ns
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.spans[i][2]:
            return self.spans[i][0]
        return "harness"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing when each gap opened."""
        ops: dict = {}
        for name, s, e in self.clipped():
            key = name[:120]
            ops[key] = ops.get(key, 0) + (e - s)
        idle: dict = {}
        for s, e in self.idle_gaps():
            key = self.host_doing(s)
            idle[key] = idle.get(key, 0) + (e - s)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v / 1e9] for k, v in top],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps]}
