"""One run of one cell: the pieces every entry shares.

A cell's configuration names its system module (benchmark/systems/
<system>.py) and its reference module (benchmark/reference/
<reference>.py); the traffic mix names its generator and the entry the
window drives. The system module's ENTRIES[entry](run) does the run:
set-up, the measured window, with --trace 1 the traced window, the
reading of the peak, then the check against the reference with the
program's state freed. It uses what this module gives it:

- `pool`, `pool_calls`: the traffic's rows on the device, enough for the
  checked calls, the warm-up, the window at the mix's pool rate, the
  probe and the traced calls;
- `window(call, first)`: issues `call(i)` back to back (a closed loop, as
  a training loop issues its steps) until `--seconds` have passed on the
  host clock, then synchronizes; the end of each call is a CUDA event on
  the card;
- `trace_ctx`: the host probe, then the traced window (torch.profiler),
  then the context every per-layer metric reads;
- `finish_program`: the peak and the per-layer metrics while the
  program's state stands; `result`: the contract's line.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, core, trace as tr

GIB = 1 << 30


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Marks:
    """Ends of calls: CUDA events on the card, host times on the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.marks: List = []

    def mark(self) -> None:
        if self.dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> List[float]:
        m = self.marks
        if self.dev.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def p95(xs: List[float]) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 95))


def _profile(dev: torch.device, body: Callable[[], None]) -> tr.Trace:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            body()
            sync(dev)
    return tr.from_profiler(prof)


class Run:
    """The state of one run of a cell (see the module docstring).

    `devices`: the devices the cell's chips are ("cuda:0", ...). `wrap`
    is called with the system object once it is built (the tests break
    the timed path through it). `readings` also reads the control and
    the planted faults; `quick` leaves out the warm-up, the windows and
    the per-layer metrics (only the check and the readings run)."""

    def __init__(self, man: Dict, cell: Dict, conf: Dict, traffic: Dict,
                 limits: Dict, seed: int, seconds: float, trace: bool,
                 devices, t_start: float, wrap: Optional[Callable] = None,
                 readings: bool = False, quick: bool = False):
        self.man, self.cell, self.conf, self.tf = man, cell, conf, traffic
        self.limits = limits
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devs = [torch.device(d) for d in devices]
        self.dev = self.devs[0]
        self.t_start = t_start
        self.wrap = wrap
        self.readings: Optional[Dict] = {} if readings else None
        self.quick = quick
        self.system = core.system(conf["system"])
        self.reference = core.reference(conf["reference"])
        self.lay = self.system.layout(conf)
        self.gen = core.generator(traffic["generator"])
        self.values: Dict[str, Optional[float]] = {}
        self.notes: List[str] = []
        self.numbers: Dict[str, float] = {}
        self.staged = 0
        self.attempted = 0
        self.failed = 0
        self.per_layer = None
        self.phases: List[tuple] = []

    def run(self) -> Dict:
        entry = self.tf["entry"]
        if entry not in self.system.ENTRIES:
            raise KeyError(f"the system {self.conf['system']!r} has no "
                           f"entry {entry!r}")
        self.phase("imports and the card")
        return self.system.ENTRIES[entry](self)

    # ------------------------------------------------------------ set-up
    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed with the notes)."""
        self.phases.append((name, time.perf_counter()))

    def end_setup(self) -> None:
        self.values["setup_s"] = time.perf_counter() - self.t_start
        t, parts = self.t_start, []
        for name, end in self.phases:
            parts.append(f"{name} {end - t:.3f} s")
            t = end
        self.notes.append("set-up: " + "; ".join(parts))

    def pool(self, tf: Dict, rows: int, stream: int, staged: bool = True):
        """`rows` rows of a traffic mix on the first device, drawn from
        the seed on `stream`; counted as the harness's bytes."""
        pool = self.gen.make_pool(tf, self.lay, rows, self.seed, stream,
                                  self.dev)
        if staged:
            self.staged += pool.nbytes
        return pool

    def pool_calls(self, tf: Dict, checked: int) -> int:
        """Calls the pool must hold distinct: the checked ones, and unless
        quick the warm-up, the window at the mix's pool rate, the probe
        and the traced calls."""
        if self.quick:
            return checked
        rows_per = tf["batch"] * tf.get("steps_per_dispatch", 1)
        window = int(np.ceil(tf["pool_examples_per_s"] * self.seconds
                             / rows_per))
        return (window + checked + tf["warmup_dispatches"]
                + tf["trace_dispatches"] + tf["host_probe_dispatches"])

    # ------------------------------------------------------------ windows
    def window(self, call: Callable[[int], object], first: int):
        """Issue call(first), call(first + 1), ... back to back for
        `--seconds`; returns (calls, wall seconds, ms between the ends of
        successive calls)."""
        dev = self.dev
        marks = Marks(dev)
        sync(dev)
        t0 = time.perf_counter()
        marks.mark()
        n = 0
        while time.perf_counter() - t0 < self.seconds:
            call(first + n)
            marks.mark()
            n += 1
        sync(dev)
        return n, time.perf_counter() - t0, marks.gaps_ms()

    def trace_ctx(self, sysm, call: Callable[[int], object], nxt: int,
                  rate: float, extra: Dict) -> Dict:
        """The host probe, then the traced window, after the measured one:
        `call(i)` issues the call on batch i, from batch `nxt` on. The
        context holds what every per-layer metric may read, and `extra`,
        the system's own (its layout, its FLOPs a call)."""
        dev, tf = self.dev, self.tf
        probe = []
        for _ in range(tf["host_probe_dispatches"]):
            sync(dev)
            tc = time.perf_counter()
            call(nxt)
            probe.append((time.perf_counter() - tc) * 1e3)
            nxt += 1
        sync(dev)
        first = nxt
        before = sysm.launches()

        def body():
            for i in range(first, first + tf["trace_dispatches"]):
                call(i)

        trc = _profile(dev, body)
        after = sysm.launches()
        k = tf.get("steps_per_dispatch", 1)
        return dict({
            "trace": trc, "entry": tf["entry"], "batch": tf["batch"],
            "steps_per_dispatch": k,
            "traced_calls": tf["trace_dispatches"],
            "traced_steps": tf["trace_dispatches"] * k,
            "host_probe_ms": probe, "examples_per_s": rate,
            "launches": {n: after[n] - before[n] for n in after},
            "card": self.card(),
        }, **extra)

    # ------------------------------------------------------------ finish
    def card(self) -> str:
        if self.dev.type == "cuda":
            return torch.cuda.get_device_name(self.dev)
        return "cpu"

    def finish_program(self, sysm, ctx: Optional[Dict]) -> None:
        """Read the peak and the per-layer metrics while the program's
        state stands."""
        for d in self.devs:
            sync(d)
        cuda = self.dev.type == "cuda"
        peak = max(torch.cuda.max_memory_allocated(d) for d in self.devs) \
            if cuda else 0
        self.device = {"platform": "gpu" if cuda else "cpu",
                       "kind": self.card(), "count": len(self.devs),
                       "memory_peak_bytes": int(peak)}
        self.values["peak_mem_gib"] = (peak - self.staged) / GIB \
            if cuda else None
        self.notes.append(f"graphed {sysm.graphed()}; peak {peak} bytes, "
                          f"{self.staged} of them the harness's")
        if ctx is not None:
            self.device["busy_s"] = tr.device_busy_s(ctx["trace"])
            self.device["window_s"] = tr.window_s(ctx["trace"])
            self.per_layer = core.read_per_layer(self.man, self.cell["name"],
                                                 ctx)
            self.breakdown = tr.breakdown(ctx["trace"])
            ran = {k: v for k, v in ctx["launches"].items() if v}
            self.notes.append(f"traced launches by the port's counters: "
                              f"{ran}")

    def free(self) -> None:
        import gc
        gc.collect()
        for d in self.devs:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()

    def result(self) -> Dict:
        correct = check.judge(self.numbers, self.limits)
        if self.trace:
            metrics = self.per_layer or {}
        else:
            metrics = core.pick(self.values,
                                core.metrics_of(self.man, self.cell["name"],
                                                "end_to_end"))
        res = {"correct": correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics,
               "device": getattr(self, "device", None)}
        if self.trace:
            res["breakdown"] = getattr(self, "breakdown", None)
        if self.readings is not None:
            res["readings"] = self.readings
        res["checks"] = {k: {"value": v, "limit": self.limits.get(k)}
                         for k, v in self.numbers.items()}
        return res
