"""Profiler and determinism switches (counterpart of
``vit_tpu/utils/profiling.py``).

- :func:`trace` profiles the enclosed block with ``torch.profiler`` (host
  and, where there is a card, CUDA activity) and writes a Chrome trace;
  :func:`vit_tpu_torch.utils.tracing.tensor_info` labels regions in it.
- :func:`kernel_times` reads each kernel's device time a launch from the
  profiler, over the records it kept, and its launches a call;
  :func:`launch_ms` one kernel's, from a window that kept a record of it.
- :func:`deterministic` turns on PyTorch's deterministic algorithms and
  turns TF32 off for matmuls and cuDNN, so that fp32 runs in true fp32 and
  repeats bit for bit; it restores all three on exit. The port's own
  kernels are deterministic already (fixed sum orders, no atomics).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace("runs/t") as prof: ...``.

    Writes ``trace.json`` under ``log_dir`` (open it in Perfetto or
    ``chrome://tracing``) and yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_times(fn, iters: int = 10) -> dict[str, tuple[float, float]]:
    """Per kernel name: ``(device ms a launch, launches a call)``, from
    ``torch.profiler`` (CUPTI) over ``iters`` calls of ``fn()`` after one.

    A launch's time is the kernel's summed device time over the records
    the profiler kept, divided by their number. The profiler misses
    records at a window's start (on an NVIDIA H100 80GB HBM3 it kept 8 of
    10 of an attention block's core launches and 19 of 20 of a forward's
    first copy, window after window), so the launches a call are
    ``count / iters`` rounded to a whole number where that is at least
    one, and taken as they stand below that (a kernel that not every call
    launches). The device time of a call is ``sum(ms * n for ms, n in
    values())``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            n = round(e.count / iters)
            out[e.key] = (e.self_device_time_total / 1e3 / e.count,
                          n if n >= 1 else e.count / iters)
    return out


def launch_ms(fn, name: str, iters: int = 10,
              tries: int = 3) -> float | None:
    """Device ms of one launch of the kernel whose name holds ``name``
    (summed, one launch each, where several do), over the records the
    profiler kept (:func:`kernel_times`), from the first of ``tries``
    windows that kept any; None where none did (on an NVIDIA H100 80GB
    HBM3, windows of a few long launches came back with no record of
    them)."""
    for _ in range(tries):
        got = [ms for k, (ms, _) in kernel_times(fn, iters).items()
               if name in k]
        if got:
            return sum(got)
    return None


@contextlib.contextmanager
def deterministic():
    """Run the enclosed block with ``torch.use_deterministic_algorithms``
    on and TF32 off for matmuls and cuDNN; restore the three settings on
    exit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
