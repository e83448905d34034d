"""train_dispatch_host_ms: host ms inside the train step's call, a
dispatch: the copies of the batch into the graph's buffers and the
replay's launch, the call returning before the card finishes. Each
probed call starts on an empty queue (a synchronize before it, outside
the time), so no back-pressure from the card counts; the mean over the
probe's calls."""

from __future__ import annotations

def read(ctx):
    if ctx["entry"] != "train" or not ctx["host_probe_ms"]:
        return None
    return sum(ctx["host_probe_ms"]) / len(ctx["host_probe_ms"])
