#!/usr/bin/env python3
"""Interleaved A/B of dot-interaction formulations at bench shapes, for
the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/ab_interact.py: the same arms, shapes (B, F, D = 2048, 27, 16) and
printout.

Each arm is the DLRM self-interaction z[b] = T[b] @ T[b]^T of a
[B, F, D] f32 tensor, timed forward and backward (the gradient of
sum(z)), chained through its carry (t <- t + 1e-6 * grad) `--reps`
times; on the card the whole chain is captured in one CUDA graph (the
JAX tool jits it) and each window replays it once, ended by a device
synchronize.

  A_einsum_bf16      models/mlp.mm(t, t^T, bf16) as the port's DLRM runs
                     it (operands rounded to bf16, f32 product)
  B_mulreduce_f32    broadcast multiply, then a sum over d
  C_einsum_f32       an f32 batched matmul (the tool turns TF32 off, as
                     chip_smoke.py does)
  D_batchminor_bf16  the bf16-rounded operands laid out [F, D, B] (batch
                     minor), contracted over d by einsum

Before timing, every arm's output and gradient are checked against the
f64 product of the arm's own operands (rel_err, within TOL). On the card
each arm's kernels are read from a torch.profiler window over one
chain, by name and device time.

    python3 tools/ab_interact_torch.py [--windows 5] [--reps 40]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from cafe_tpu_torch.models.mlp import mm  # noqa: E402
from cafe_tpu_torch.utils.timing import fence  # noqa: E402
from tools.compiled_call_torch import compiled_call  # noqa: E402

B, F, D = 2048, 27, 16
TOL = 2e-3        # the bf16 towers' bound, relative to the largest value


def a_bf16(t):
    return mm(t, t.transpose(1, 2), torch.bfloat16)


def b_vpu(t):
    return torch.sum(t[:, :, None, :] * t[:, None, :, :], dim=-1)


def c_f32(t):
    return torch.einsum("bfd,bgd->bfg", t, t)


def d_minorbatch(t):
    tt = t.to(torch.bfloat16).float().permute(1, 2, 0)    # [F, D, B]
    return torch.einsum("fdb,gdb->bfg", tt, tt)


ARMS = {"A_einsum_bf16": a_bf16, "B_mulreduce_f32": b_vpu,
        "C_einsum_f32": c_f32, "D_batchminor_bf16": d_minorbatch}


def value_and_grad(interact, t):
    """interact(t) and the gradient of its sum at t."""
    x = t.detach().requires_grad_()
    with torch.enable_grad():
        z = interact(x)
        (g,) = torch.autograd.grad(z.sum(), x)
    return z.detach(), g


def one(interact):
    """fwd+bwd chained through the carry, so reps serialize."""
    def step(t):
        return t + 1e-6 * value_and_grad(interact, t)[1]
    return step


def exact(t, bf16: bool):
    """The interaction and its gradient in f64 from t's operands (rounded
    to bf16 first for the bf16 arms, whose gradient autograd rounds to
    bf16 on the way back, as the arms' own)."""
    x = t.double().detach().requires_grad_()
    with torch.enable_grad():
        y = x.to(torch.bfloat16).double() if bf16 else x
        z = y @ y.transpose(1, 2)
        (g,) = torch.autograd.grad(z.sum(), x)
    return z.detach(), g


def rel_err(got, want, bf16: bool) -> float:
    """max |got - want| relative to max |want|, less one bf16 rounding
    step of each value for the bf16 arms (their gradient is rounded to
    bf16, and a sum in another order may round to the neighbour)."""
    ulp = 2.0 ** -8 if bf16 else 0.0
    d = (got.double() - want.double()).abs() - ulp * want.double().abs()
    return float(d.clamp_min(0).max() / want.double().abs().max())


def check(t) -> dict:
    """Each arm's output and gradient against the f64 product of its own
    operands: within TOL (rel_err)."""
    out = {}
    for name, fn in ARMS.items():
        bf16 = name.endswith("bf16")
        ref_z, ref_g = exact(t, bf16)
        z, g = value_and_grad(fn, t)
        out[name] = {"out": rel_err(z, ref_z, bf16),
                     "grad": rel_err(g, ref_g, bf16)}
        if not max(out[name].values()) <= TOL:
            raise AssertionError(f"{name}: {out[name]} above {TOL}")
    return out


def arm_kernels(run, dev, top=4, windows=3) -> list:
    """[(kernel, device us a chain)] of one replay, largest first. A
    profiler window has come back with no device row for a replay that
    ran; up to `windows` windows are taken until one holds rows."""
    if dev.type != "cuda":
        return []
    from torch.profiler import ProfilerActivity, profile
    rows = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = sorted(((a.key, a.self_device_time_total) for a in
                       prof.key_averages()
                       if a.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda x: -x[1])
        if rows:
            break
    return [[k[:100], us] for k, us in rows[:top]]


def run(windows=5, reps=40, device="cuda", batch=B) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    t0_arr = torch.from_numpy(rng.standard_normal((batch, F, D))
                              .astype(np.float32)).to(dev)
    numerics = check(t0_arr)
    compiled = {}
    for name, fn in ARMS.items():
        step = one(fn)

        def chain(step=step):
            t = t0_arr
            for _ in range(reps):
                t = step(t)
            return t
        compiled[name] = compiled_call(chain, dev)
        fence(compiled[name]())
    results = {k: [] for k in compiled}
    for _ in range(windows):
        for name, run_chain in compiled.items():
            t0 = time.perf_counter()
            fence(run_chain())
            results[name].append((time.perf_counter() - t0) / reps * 1e6)
    print(f"us per fwd+bwd interaction (median of {windows} "
          f"interleaved windows, {reps} reps):")
    for name, ts in results.items():
        print(f"  {name:20s} {float(np.median(ts)):8.1f} us  "
              f"(min {min(ts):.1f} max {max(ts):.1f})")
    rec = {"median_us": {k: float(np.median(v)) for k, v in results.items()},
           "windows_us": results, "numerics_vs_f64": numerics,
           "kernels": {k: arm_kernels(c, dev) for k, c in compiled.items()},
           "graphed": all(c.graphed for c in compiled.values()),
           "shape": [batch, F, D], "reps": reps,
           "device": device_name(dev)}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.windows, args.reps, args.device)


if __name__ == "__main__":
    main()
