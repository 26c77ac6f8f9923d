"""The device's side of a traced window, from `torch.profiler`.

The profiler records the card's operations (kernels, copies, sets) on its
own clock. A marker operation launched on an idle card at a known host
time, at the start and at the end, ties that clock to the host's
`time.perf_counter`, so device intervals and the program's host spans
lie on one time line. From them: the seconds the device was busy (the
union of its kernels' intervals: a copy or a memset alone keeps the copy
engine busy while the SMs idle), the operations that took most time,
copies included, and the idle gaps, attributed first to a copy or set
running alone (`copy_only`), then to the host span that was open over it
(`no_program_span` where none was).

Interval sets are sorted lists of disjoint (start, end) pairs in host
seconds.
"""
from __future__ import annotations

import sys
import time

# host spans that can explain an idle device, most specific first
HOST_SPANS = ("dispatch", "compile", "transfer", "decode", "optimize", "parse")
# the profiler's names of operations that are not kernels
COPY_PREFIXES = ("Memcpy", "Memset")


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def merge(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs, ys) -> list[tuple[float, float]]:
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list[tuple[float, float]]:
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def _marker(torch) -> None:
    torch.cuda.synchronize()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


class DeviceTrace:
    """Profiles the card between `start()` and `stop()`."""

    def __init__(self, torch):
        self.torch = torch
        self.ops: list[tuple[str, float, float]] = []  # (name, start, end)

    def start(self) -> None:
        t = self.torch
        self.prof = t.profiler.profile(
            activities=[t.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        t.cuda.synchronize()
        self.h0 = time.perf_counter()
        _marker(t)

    def stop(self) -> None:
        t = self.torch
        t.cuda.synchronize()
        self.h1 = time.perf_counter()
        _marker(t)
        self.prof.stop()
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != t.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                a, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                a, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            ops.append((a, a + d, e.name()))
        ops.sort()
        if len(ops) < 2:
            self.ops = []
            return
        # the first and last operations are the markers
        offset = ops[0][0] - self.h0
        drift = (ops[-1][0] - ops[0][0]) - (self.h1 - self.h0)
        print(f"device trace: {len(ops) - 2} operations, clock drift "
              f"{drift * 1e3:.3f} ms over {self.h1 - self.h0:.3f} s",
              file=sys.stderr)
        self.ops = [(n, a - offset, b - offset) for a, b, n in ops[1:-1]]

    def busy(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """The union of the kernels' intervals in [lo, hi]."""
        return clip(merge((a, b) for n, a, b in self.ops if is_kernel(n)),
                    lo, hi)

    def copies(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """The union of the copies' and sets' intervals in [lo, hi]."""
        return clip(merge((a, b) for n, a, b in self.ops if not is_kernel(n)),
                    lo, hi)

    def top_ops(self, lo: float, hi: float, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, a, b in self.ops:
            a, b = max(a, lo), min(b, hi)
            if a < b:
                key = name[:64]
                by[key] = by.get(key, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, lo: float, hi: float, spans, n: int = 10) -> list:
        """Idle seconds in [lo, hi] by the host span open over them;
        `spans` are (name, start, end) in host seconds."""
        idle = subtract([(lo, hi)], self.busy(lo, hi))
        out = []
        part = intersect(idle, self.copies(lo, hi))
        if part:
            out.append(["copy_only", total(part)])
            idle = subtract(idle, self.copies(lo, hi))
        for name in HOST_SPANS:
            cover = merge((a, b) for s, a, b in spans if s == name)
            part = intersect(idle, cover)
            if part:
                out.append([name, total(part)])
                idle = subtract(idle, cover)
        out.append(["no_program_span", total(idle)])
        return sorted(out, key=lambda kv: -kv[1])[:n]
