"""Observability: text log, TensorBoard scalars, step timing, profiler
(counterpart of vcrnet_tpu/utils/logging.py).

  IOStream       stdout + a log file
  MetricsWriter  tensorboardX scalars per epoch, a no-op when ``log_dir``
                 is None or tensorboardX is missing
  StepTimer      steps/sec with exponential smoothing, on the host clock
  Progress       a one-line progress bar for batch loops
  profile_trace  a ``torch.profiler`` trace of the CPU and the card into
                 ``log_dir`` (the JAX package's is ``jax.profiler``'s)
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional


class IOStream:
    """print, and append to a log file."""

    def __init__(self, path: str):
        self.f = open(path, "a")

    def cprint(self, text: str):
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


class MetricsWriter:
    """TensorBoard scalar writer; a no-op without ``log_dir`` or tensorboardX."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir is None:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(log_dir=log_dir)

    def scalar(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def scalars(self, prefix: str, values: dict, step: int):
        for k, v in values.items():
            if isinstance(v, (int, float)):
                self.scalar(f"{prefix}/{k}", v, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class StepTimer:
    """Wall-clock seconds a step with exponential smoothing. The host
    clock: on the card it measures what the host waits for, so time work
    that ends in a synchronise."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._last = None
        self.step_time = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (dt if self.step_time is None
                              else self.ema * self.step_time + (1 - self.ema) * dt)
        self._last = now
        return self.step_time

    def rate(self, items_per_step: int = 1) -> Optional[float]:
        return items_per_step / self.step_time if self.step_time else None


class Progress:
    """A one-line progress bar for batch loops, counting the batches the
    host hands out (no device synchronise). Drawn on stderr when it is a
    TTY; VCRNET_PROGRESS=1 forces it on, VCRNET_PROGRESS=0 off."""

    def __init__(self, total: Optional[int] = None, desc: str = ""):
        self.total = total
        self.desc = desc
        self.n = 0
        self._t0 = time.perf_counter()
        self._last_render = 0.0
        self._file = sys.stderr
        force = os.environ.get("VCRNET_PROGRESS", "")
        if force:
            self.enabled = force != "0"
        else:
            self.enabled = bool(getattr(self._file, "isatty", lambda: False)())

    def update(self, k: int = 1) -> None:
        self.n += k
        if not self.enabled:
            return
        now = time.perf_counter()
        done = self.total is not None and self.n >= self.total
        if now - self._last_render < 0.25 and not done:
            return
        self._last_render = now
        elapsed = now - self._t0
        rate = self.n / elapsed if elapsed > 0 else 0.0
        if self.total:
            eta = (self.total - self.n) / rate if rate > 0 else 0.0
            msg = (f"\r{self.desc}: {self.n}/{self.total} "
                   f"[{elapsed:.0f}s<{eta:.0f}s, {rate:.2f} batch/s]")
        else:
            msg = f"\r{self.desc}: {self.n} [{elapsed:.0f}s, {rate:.2f} batch/s]"
        self._file.write(msg)
        self._file.flush()

    def close(self) -> None:
        if self.enabled and self.n:
            self._file.write("\n")
            self._file.flush()

    def wrap(self, iterable, total: Optional[int] = None):
        """Yield from ``iterable`` with a tick per item."""
        if total is not None:
            self.total = total
        elif self.total is None:
            try:
                self.total = len(iterable)
            except TypeError:
                pass
        try:
            for item in iterable:
                yield item
                self.update()
        finally:
            self.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card, written into ``log_dir`` as a Chrome trace when the block ends;
    a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
