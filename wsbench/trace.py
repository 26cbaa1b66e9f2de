"""The traced run's profile, reduced to spans and device operations.

torch.profiler records the host's ranges (the harness's spans, opened by
record_function around calls into the program's layers), the CUDA runtime
and driver calls, and every kernel, copy and set on the device. Its Chrome
trace links each device operation to the host call that launched it by a
correlation id. A layer's device time is the time of the device operations
launched while that layer's span was open; no kernel name is matched.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""

    spans: list  # (name, start, end), the harness's spans
    dev_start: np.ndarray  # [N] device operations
    dev_end: np.ndarray
    launch: np.ndarray  # [N] host time of the launching call, NaN if unlinked
    dev_name: list  # [N]

    @classmethod
    def from_chrome(cls, path: str, span_names) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = set(span_names)
        spans, launches, dev = [], {}, []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            if cat == "user_annotation" and ev.get("name") in names:
                spans.append((ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            elif cat in LAUNCH_CATS:
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = float(ev["ts"])
            elif cat in DEVICE_CATS:
                dev.append((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)),
                            ev.get("args", {}).get("correlation"), ev.get("name", cat)))
        dev.sort()
        spans.sort(key=lambda sp: sp[1])
        return cls(spans=spans,
                   dev_start=np.array([d[0] for d in dev], dtype=np.float64),
                   dev_end=np.array([d[1] for d in dev], dtype=np.float64),
                   launch=np.array([launches.get(d[2], np.nan) for d in dev],
                                   dtype=np.float64),
                   dev_name=[d[3] for d in dev])

    def intervals(self, name: str):
        """(starts, ends) of the spans called `name`, in time order."""
        sel = [(a, b) for n, a, b in self.spans if n == name]
        return (np.array([a for a, _ in sel], dtype=np.float64),
                np.array([b for _, b in sel], dtype=np.float64))

    def launched_in(self, name: str) -> np.ndarray:
        """[N] bool: device operations launched while a `name` span was open
        (spans of one name do not overlap: they come from one thread and
        none of them calls itself)."""
        st, en = self.intervals(name)
        if len(st) == 0:
            return np.zeros(len(self.launch), dtype=bool)
        i = np.searchsorted(st, self.launch, side="right") - 1
        ok = (i >= 0) & ~np.isnan(self.launch)
        j = np.maximum(i, 0)
        return ok & (self.launch <= en[j])

    def device_s(self, name: str) -> float:
        """Seconds of device operations launched inside `name` spans."""
        sel = self.launched_in(name)
        return float((self.dev_end[sel] - self.dev_start[sel]).sum()) * 1e-6

    def window(self, name: str):
        """(first start, last end) of the `name` spans."""
        st, en = self.intervals(name)
        return float(st.min()), float(en.max())

    def busy(self, lo: float, hi: float) -> float:
        """Microseconds of [lo, hi] in which some device operation ran: the
        union of their intervals."""
        return union_length(np.clip(self.dev_start, lo, hi), np.clip(self.dev_end, lo, hi))

    def busy_intervals(self, lo: float, hi: float):
        return merge(np.clip(self.dev_start, lo, hi), np.clip(self.dev_end, lo, hi))

    def per_span_busy(self, name: str):
        """(durations, device-busy microseconds) of each `name` span: the
        union of the device operations launched inside it, within it."""
        st, en = self.intervals(name)
        i = np.searchsorted(st, self.launch, side="right") - 1
        j = np.maximum(i, 0)
        inside = (i >= 0) & ~np.isnan(self.launch) & (self.launch <= en[j]) \
            if len(st) else np.zeros(len(self.launch), dtype=bool)
        busy = np.zeros(len(st))
        for b in np.unique(j[inside]):
            sel = inside & (j == b)
            busy[b] = union_length(np.clip(self.dev_start[sel], st[b], en[b]),
                                   np.clip(self.dev_end[sel], st[b], en[b]))
        return en - st, busy

    def linked_share(self) -> float:
        """Share of device operations linked to a launching call."""
        n = len(self.launch)
        return float((~np.isnan(self.launch)).sum() / n) if n else 1.0

    # ----------------------------------------------------------- breakdown --

    def innermost_at_launch(self):
        """[N] the innermost span open at each operation's launch."""
        marks = []
        for k, (name, a, b) in enumerate(self.spans):
            marks.append((a, 0, k))
            marks.append((b, 2, k))
        for i, t in enumerate(self.launch):
            if not np.isnan(t):
                marks.append((t, 1, i))
        marks.sort()
        stack, out = [], [NO_SPAN] * len(self.launch)
        for _, kind, k in marks:
            if kind == 0:
                stack.append(k)
            elif kind == 2:
                if k in stack:
                    stack.remove(k)
            else:
                out[k] = self.spans[stack[-1]][0] if stack else NO_SPAN
        return out

    def segments(self, lo: float, hi: float):
        """[(start, end, innermost span)] covering [lo, hi]."""
        marks = sorted([(a, 0, k) for k, (_, a, _) in enumerate(self.spans)]
                       + [(b, 1, k) for k, (_, _, b) in enumerate(self.spans)])
        out, stack, t = [], [], lo
        for time, kind, k in marks:
            time = min(max(time, lo), hi)
            if time > t:
                out.append((t, time, self.spans[stack[-1]][0] if stack else NO_SPAN))
                t = time
            if kind == 0:
                stack.append(k)
            elif k in stack:
                stack.remove(k)
        if hi > t:
            out.append((t, hi, self.spans[stack[-1]][0] if stack else NO_SPAN))
        return out

    def breakdown(self, lo: float, hi: float, top: int = 10) -> dict:
        """The device operations that took most time, by the span that
        launched them and their name, and the device's idle time, by the
        innermost span open on the host meanwhile; seconds, largest first."""
        inside = (self.dev_end > lo) & (self.dev_start < hi)
        where = self.innermost_at_launch()
        ops = defaultdict(float)
        for i in np.nonzero(inside)[0]:
            ops[f"{where[i]}: {short_name(self.dev_name[i])}"] += \
                (min(self.dev_end[i], hi) - max(self.dev_start[i], lo)) * 1e-6
        busy_a, busy_b = self.busy_intervals(lo, hi)
        gaps_a = np.concatenate([[lo], busy_b])
        gaps_b = np.concatenate([busy_a, [hi]])
        keep = gaps_b > gaps_a
        gaps_a, gaps_b = gaps_a[keep], gaps_b[keep]
        idle = defaultdict(float)
        g = 0
        for a, b, name in self.segments(lo, hi):
            while g < len(gaps_a) and gaps_b[g] <= a:
                g += 1
            h = g
            while h < len(gaps_a) and gaps_a[h] < b:
                idle[name] += (min(b, gaps_b[h]) - max(a, gaps_a[h])) * 1e-6
                h += 1
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def merge(a: np.ndarray, b: np.ndarray):
    """The union of intervals [a_i, b_i] as disjoint sorted intervals."""
    if len(a) == 0:
        return a, b
    o = np.argsort(a, kind="stable")
    a, b = a[o], b[o]
    reach = np.maximum.accumulate(b)
    start = np.ones(len(a), dtype=bool)
    start[1:] = a[1:] > reach[:-1]
    idx = np.nonzero(start)[0]
    ends = np.append(reach[idx[1:] - 1], reach[-1])
    return a[idx], ends


def union_length(a: np.ndarray, b: np.ndarray) -> float:
    s, e = merge(a, b)
    return float((e - s).sum())


def short_name(name: str) -> str:
    """A kernel's or copy's name without its argument and template lists."""
    s = name.replace("(anonymous namespace)", "").removeprefix("void ").strip()
    s = s.split("(")[0]
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s[-80:] if s else name[:80]
