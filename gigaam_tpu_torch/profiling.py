"""Tracing and timing of the port (counterpart of
``gigaam_tpu/profiling.py``).

* ``trace(log_dir)``: a context manager around ``torch.profiler`` (host and,
  on the card, CUDA activity) that writes a Chrome trace of everything
  inside into ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
  the JAX package's writes an XProf trace.
* ``device_timeit(fn, args)`` times ``fn(*args)`` the way the JAX package's
  ``device_timeit`` does: runs of ``k`` calls (on the card one CUDA graph
  replay each, with no host work between the calls), the median of
  ``reps`` runs, the best of ``windows`` medians, in seconds per call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its Chrome trace to
    ``<log_dir>/trace_<pid>_<n>.json``; yields the profiler (its
    ``key_averages()`` summarise the same events)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


def _first_tensor(out):
    """The first tensor of ``fn``'s output: the output itself or the first
    element of a tuple or list."""
    return out if isinstance(out, torch.Tensor) else out[0]


def device_timeit(
    fn: Callable,
    args: Sequence,
    perturb_arg: int = 0,
    k: int = 10,
    windows: int = 3,
    reps: int = 5,
    chain: bool = False,
) -> float:
    """Median-of-best-window seconds per call of ``fn(*args)``.

    A run is ``k`` calls back to back.  One untimed run comes first (it
    builds the kernels); then ``windows`` windows of ``reps`` runs, and the
    least of the windows' median seconds per call is returned.

    When ``args[perturb_arg]`` is a CUDA tensor, the ``k`` calls are
    captured once into a CUDA graph and a run is one replay of it, timed
    with CUDA events: the counterpart of the JAX version's loop on the
    device, with no host work between the calls.  ``fn`` must then be
    capturable (no synchronisation, no host reads of device values).  On
    the CPU a run is ``k`` eager calls on the host clock.

    ``chain=True`` feeds each call's output (its first tensor, which must
    have the shape of ``args[perturb_arg]``; it is cast to that argument's
    dtype) back as ``args[perturb_arg]`` of the next call, as the JAX
    version does: a run is then one dependent sequence, each run starting
    again from ``args``.

    PyTorch runs each call as it is written, so no compiler can collapse
    repeated calls or hoist them out of the loop: unlike the JAX version,
    nothing perturbs the inputs, no second copy of them alternates with the
    first, and ``perturb_arg`` only selects the argument that ``chain``
    replaces.
    """
    x0 = args[perturb_arg]

    def calls() -> None:
        a = list(args)
        for _ in range(k):
            out = fn(*a)
            if chain:
                a[perturb_arg] = _first_tensor(out).to(x0.dtype)

    if isinstance(x0, torch.Tensor) and x0.is_cuda:
        with torch.cuda.device(x0.device):
            calls()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                calls()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)

            def one_run() -> float:
                start.record()
                graph.replay()
                stop.record()
                stop.synchronize()
                return start.elapsed_time(stop) / 1e3 / k

            return _best_window(one_run, windows, reps)

    def one_run() -> float:
        t0 = time.perf_counter()
        calls()
        return (time.perf_counter() - t0) / k

    return _best_window(one_run, windows, reps)


def _best_window(one_run: Callable[[], float], windows: int,
                 reps: int) -> float:
    """One untimed run, then the least of ``windows`` medians of ``reps``
    runs."""
    one_run()
    return min(float(np.median([one_run() for _ in range(reps)]))
               for _ in range(windows))
