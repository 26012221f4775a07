"""The traced stretch of a `--trace 1` run: `torch.profiler` over a run of
consecutive batches inside the window, reduced to device time by kernel,
the device's busy time (the union of every kernel's and copy's interval),
the stretch's wall time, and the idle gaps labelled by what the host was
doing (the innermost host range that covers each gap's middle).

The port's own kernels are named in `kernels.json` (kernel wrapper ->
CUDA function names); every other device kernel is PyTorch's.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ANNOTATION = "portbench."     # the harness's own host ranges


def port_kernels() -> Dict[str, List[str]]:
    with open(os.path.join(HERE, "kernels.json")) as f:
        return json.load(f)


def short_name(name: str) -> str:
    """A kernel's name without its signature and namespace noise."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:80]


def wrapper_of(name: str, table: Dict[str, List[str]]) -> Optional[str]:
    """The port's kernel wrapper a device kernel belongs to, or None."""
    base = name.split("<")[0]
    for wrapper, functions in table.items():
        if base in functions:
            return wrapper
    return None


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def label_gaps(gaps: List[Tuple[float, float]],
               host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of device idle time by the innermost host range (latest
    start) covering each gap's middle; "(no host range)" where none does.
    Times in microseconds in, seconds out."""
    host = sorted(host)
    by_label: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    j = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = max(active)[2] if active else "(no host range)"
        by_label[label] = by_label.get(label, 0.0) + (e - s) / 1e6
    return by_label


@dataclass
class Summary:
    """The traced stretch, reduced."""
    batches: int
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)  # by name
    kernel_n: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def port_s(self, wrapper: str) -> Optional[float]:
        """Device seconds of one port kernel wrapper's functions; None if
        none ran."""
        table = port_kernels()
        hits = [t for n, t in self.kernel_s.items()
                if wrapper_of(n, table) == wrapper]
        return sum(hits) if hits else None

    def port_n(self, wrapper: str) -> int:
        """Launches of one port kernel wrapper's functions."""
        table = port_kernels()
        return sum(c for n, c in self.kernel_n.items()
                   if wrapper_of(n, table) == wrapper)

    def torch_s(self) -> float:
        """Device seconds of every kernel that is not the port's own (no
        copies)."""
        table = port_kernels()
        return sum(t for n, t in self.kernel_s.items()
                   if not is_copy(n) and wrapper_of(n, table) is None)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}


def summarize(prof, batches: int, window_s: float) -> Summary:
    """Reduce a finished profile of ``batches`` batches over ``window_s``
    wall seconds."""
    from torch.autograd import DeviceType
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                ANNOTATION):
            if e.device_type == DeviceType.CPU:
                host.append((s, t, e.name))
            continue
        if e.device_type == DeviceType.CUDA:
            name = short_name(e.name)
            dev.append((s, t))
            kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) / 1e6
            kernel_n[name] = kernel_n.get(name, 0) + 1
        elif e.device_type == DeviceType.CPU:
            host.append((s, t, e.name))
    busy = merge(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    return Summary(batches=batches, window_s=window_s,
                   busy_s=sum(e - s for s, e in busy) / 1e6,
                   kernel_s=kernel_s, kernel_n=kernel_n,
                   idle_by_host=label_gaps(gaps, host))


def activities(device) -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm_profiler(fn, device) -> None:
    """Profile one call of ``fn`` and throw the trace away: the first
    profiler session of a process loads and starts the device tracer, which
    takes seconds, so a traced run pays it in set-up, not in its window."""
    from torch.profiler import profile
    with profile(activities=activities(device)):
        fn()
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)


class Stretch:
    """The window's hook that profiles ``n_batches`` batches from the first
    batch sent ``after_s`` seconds into the window. The stretch's wall time
    runs from a device sync before its first batch to one after its last.
    `finish` reduces the trace once the window has closed."""

    def __init__(self, after_s: float, n_batches: int, device):
        self.after_s, self.n_batches, self.device = after_s, n_batches, device
        self.t_window = None
        self.start_i = self.end_i = None
        self.prof = None
        self.wall_s = 0.0
        self._t0 = 0.0

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, i: int) -> None:
        from torch.profiler import profile
        now = time.perf_counter()
        if self.t_window is None:
            self.t_window = now
        if self.start_i is None and now - self.t_window >= self.after_s:
            self.prof = profile(activities=activities(self.device))
            self.prof.__enter__()
            self._sync()
            self.start_i, self._t0 = i, time.perf_counter()
        elif self.end_i is None and self.start_i is not None and (
                i - self.start_i >= self.n_batches):
            self._sync()
            self.wall_s = time.perf_counter() - self._t0
            self.prof.__exit__(None, None, None)
            self.end_i = i

    def finish(self, n_batches: int) -> Optional[Summary]:
        """Close a stretch the window's end cut short, and reduce the trace
        (None if the window ended before the stretch began)."""
        if self.start_i is None:
            return None
        if self.end_i is None:
            self._sync()
            self.wall_s = time.perf_counter() - self._t0
            self.prof.__exit__(None, None, None)
            self.end_i = n_batches
        return summarize(self.prof, self.end_i - self.start_i, self.wall_s)
