"""Timing on the card with CUDA events.

Two numbers per function, both from events on the current stream, read
after a synchronise, after a warm-up:

  * `cuda_time_ms`: device time per call. The timed calls are queued
    behind a GPU sleep that outlasts their enqueue, so the interval between
    the events holds only device work (kernels and the gaps between them on
    the card), not the host's launch overhead.
  * `call_time_ms`: time per call of back-to-back calls, what a caller
    that launches one after another pays: the larger of device time and
    host overhead per call.

There is no CPU fallback; without a card both raise.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _events():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA timing needs a CUDA device")
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _sleep_cycles_per_ms() -> float:
    start, stop = _events()
    torch.cuda._sleep(1_000)  # warm
    start.record()
    torch.cuda._sleep(10_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(stop)


def call_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of back-to-back `fn()` calls."""
    start, stop = _events()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of `fn()` (host overhead hidden)."""
    start, stop = _events()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    # Sleep twice the observed enqueue time (plus 1 ms) so that every timed
    # call is queued before the first one can start.
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (2 * enqueue_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall_time_s(fn: Callable[[], object]) -> tuple[object, float]:
    """(result, seconds) of one call of `fn()` that ends in a device
    synchronise: a step or request time on the host's clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0
