"""Timing helpers of the A/B tools (``k1_ab.py``, ``k2_prefill_ab.py``,
``k3_ab.py``), each run from the repo root on a machine with a CUDA card.

* :func:`event_ms`: CUDA events around ``iters`` back-to-back calls after
  ``warmup`` calls, ms a call;
* :func:`device_ms`: the profiler's kernel time a call (kernels whose name
  holds ``part``), the largest of up to three windows of ``iters`` calls
  whose kernel counts are whole multiples of ``iters`` (the profiler can
  lose events), else None;
* :func:`graph_ms`: CUDA events around replays of a CUDA graph of
  ``calls`` calls, ms a call (the device's time with the host's issue
  taken out, as a replayed step sees it);
* :func:`issue_us`: the host's time to issue one call (``iters`` calls
  with no sync between them, then one sync);
* :func:`card`: the card's name and power limit as ``nvidia-smi`` gives
  them;
* :func:`spread`: how far a set of one figure's readings part, max / min
  - 1.

torch is imported inside each function, after the tool has put the
checkout it measures on ``sys.path``.
"""
from __future__ import annotations

import subprocess
import time


def event_ms(fn, iters, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, part="", tries=6):
    import torch
    from torch.profiler import ProfilerActivity, profile
    best, whole = None, 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and part in e.key and e.count]
        if hits and all(e.count % iters == 0 for e in hits):
            ms = sum(e.self_device_time_total for e in hits) / 1e3 / iters
            best = ms if best is None else max(best, ms)
            whole += 1
            if whole == 3:
                break
    return best


def graph_ms(fn, calls=20, replays=10):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                         # the stream's first use, outside
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def issue_us(fn, iters=200):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def spread(values):
    values = [v for v in values if v is not None]
    return max(values) / min(values) - 1.0 if values else None
