"""Device timing for codec work (used by ``bench.py`` and
``benchmarks/pareto.py``): the counterpart of
``shared_tensor_tpu/utils/timing.py``; the per-launch timers of single
kernels, :func:`event_ms` and :func:`graph_ms`, with :func:`copy_ms`, the
card's streaming rate for the same bytes; and :class:`Spans`, the stage
times of a training step.

The JAX version chains L frames inside one jitted ``fori_loop``. PyTorch
runs eagerly, so here the chain is a Python loop of L frames enqueued on
the current CUDA stream between two CUDA events, with nothing that
synchronizes inside the loop; the events give the device's time for the
whole chain, including any gaps the host leaves between launches. On the
CPU (for tests only) the loop is timed with ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import math
import time
from typing import Callable, Iterator

import torch

MAX_LENGTH = 4_000_000


def _default_residual(n: int, device: torch.device) -> Callable[[int], torch.Tensor]:
    def make(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(n, generator=gen, device=device, dtype=torch.float32)

    return make


def codec_frame_time(
    codec,
    n: int,
    policy,
    make_residual: Callable[[int], torch.Tensor] | None = None,
    target_seconds: float = 3.0,
    reps: int = 2,
    budget_s: float | None = None,
    device: str | torch.device | None = None,
) -> float:
    """Seconds per codec roundtrip frame (sender ``codec.quantize`` then
    receiver ``codec.apply_frame``) at size ``n`` (a multiple of 128, no
    padding). ``codec`` is any module with those two functions:
    ``ops.codec_cuda`` (the kernels) or ``ops.codec`` (the plain golden).

    ``make_residual(seed)`` supplies the starting residual (default: standard
    normal from a ``torch.Generator`` seeded with ``seed``, so the scale
    stays nonzero and every frame does the full work). The chain is grown
    until one run of it lasts ``target_seconds``; each length is run ``reps``
    times from fresh state and the best kept. ``budget_s`` is a hard budget
    for the whole measurement: when it trips, the best estimate so far is
    returned. ``device`` defaults to ``cuda``; pass ``cpu`` to time the plain
    path on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("codec_frame_time on cuda needs a CUDA device")
    deadline = None if budget_s is None else time.monotonic() + budget_s
    if make_residual is None:
        make_residual = _default_residual(n, dev)

    def run(length: int) -> float:
        best = math.inf
        for rep in range(reps):
            r = make_residual(rep).to(device=dev, dtype=torch.float32).contiguous()
            v = torch.zeros(n, dtype=torch.float32, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(length):
                    frame, r = codec.quantize(r, n, policy)
                    v = codec.apply_frame(v, frame, n)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(length):
                    frame, r = codec.quantize(r, n, policy)
                    v = codec.apply_frame(v, frame, n)
                dt = time.perf_counter() - t0
            del r, v
            best = min(best, dt)
            if deadline is not None and time.monotonic() > deadline:
                break
        return best

    # Warm up (loads the kernels, fills the allocator's cache), then grow
    # the chain until one run lasts target_seconds: a short run's time per
    # frame over-counts fixed costs, so each step re-projects from the last.
    run(1)
    length = 1
    t = run(length)
    while t < target_seconds and length < MAX_LENGTH:
        est = max(t / length, 1e-9)
        nxt = min(MAX_LENGTH, max(length * 2, int(target_seconds / est)))
        if deadline is not None:
            # one eager chain cannot be interrupted: grow only as far as
            # its reps are projected to fit in what is left of the budget
            nxt = min(nxt, int((deadline - time.monotonic()) / (est * reps)))
            if nxt <= length:
                break
        length = nxt
        t = run(length)
    return t / length


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: ``iters`` eager calls between two CUDA
    events, after ``warmup`` calls. The host's launch cost shows whenever
    it exceeds the device's time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def no_collection() -> Iterator[None]:
    """No garbage collection inside the block (a capture): a finalizer the
    collector runs in the capturing thread, freeing a CUDA object of work
    done before, invalidates the capture (phase 22a of ``chip_smoke.py``
    died so twice with no other thread alive, and phase 22b once, in a
    link's burst graph, ``core._BurstGraph``)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def graph_ms(fn: Callable[[], object], iters: int, reps: int = 3) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's launch
    cost is not in the time. The capture is thread-local: a call another
    thread makes meanwhile (a peer's send thread syncing its copy) does not
    invalidate it; and no collection runs inside it (:func:`no_collection`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del g
    return ms


def l2_sets(nbytes: float, device) -> int:
    """How many sets of buffers of ``nbytes`` together hold four times the
    card's L2: a timed loop that takes the next set at every launch then
    streams from device memory, not from the L2."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return max(1, math.ceil(4 * l2 / nbytes))


def copy_ms(nbytes: float, device, timer: Callable[[Callable[[], object]], float], sets: int = 1) -> float:
    """ms of one device-to-device ``copy_`` that reads and writes ``nbytes``
    in all (half each way), timed by ``timer(fn)``: what the card streams
    at that size, the yardstick beside a kernel's bytes bound. With
    ``sets`` > 1 each call copies the next of that many buffer pairs."""
    pairs = [(torch.empty(int(nbytes) // 8, device=device), torch.empty(int(nbytes) // 8, device=device))
             for _ in range(sets)]
    turn = itertools.cycle(pairs)

    def copy():
        src, dst = next(turn)
        dst.copy_(src)

    ms = timer(copy)
    del pairs, turn
    return ms


class Spans:
    """Wall time of the named consecutive stages of a repeated piece of
    work (a training step), summed over its repeats: :meth:`start` opens
    the first stage, each :meth:`mark` closes the stage that ends there.
    On a CUDA device every start and mark first waits for the device, so a
    stage's time holds its kernels, not just their launches; timing thus
    serializes what it times (an overlapped collective included) and is
    for attribution, not for the throughput of untimed work."""

    def __init__(self, device=None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t: float | None = None

    def _now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def start(self) -> None:
        self._t = self._now()

    def mark(self, name: str) -> None:
        if self._t is None:
            raise RuntimeError("Spans.mark before start")
        now = self._now()
        self.totals[name] = self.totals.get(name, 0.0) + now - self._t
        self.counts[name] = self.counts.get(name, 0) + 1
        self._t = now

    def ms(self) -> dict[str, float]:
        """Mean ms per occurrence of each stage."""
        return {k: 1e3 * v / self.counts[k] for k, v in self.totals.items()}
