"""Tracing / profiling utilities.

Counterpart of rwkv_lm_ext_tpu/utils/profiling.py:17-77: a device trace
around a code block (``torch.profiler`` over CPU and CUDA activity, where
the JAX package starts ``jax.profiler``), a wall-clock decorator, and a
throughput meter matching the reference's logged ``REAL it/s`` / ``Kt/s``
metrics (src/trainer.py:121-129).
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from typing import Optional

import torch


def _cuda_sync() -> None:
    """Wait for the GPU's queued work, where this process has used one: a
    CUDA launch returns before its kernel runs."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Capture a CPU + CUDA profile around a code block and write it under
    ``log_dir`` as a ``*.pt.trace.json`` (TensorBoard's torch profiler
    plugin, Perfetto or chrome://tracing read it):

        with profile_trace("traces"):
            loss = step(batch); loss.item()

    ``log_dir`` defaults to ``torch-trace`` under the temporary directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        _cuda_sync()


def record_time(fn=None, *, name: Optional[str] = None):
    """Wall-clock decorator (the reference's vestigial record_time,
    src/utils.py:6-14): prints ``[time] <name>: <seconds>s``. Where the
    process has used a GPU, the clock is read after a synchronize, so the
    time covers the kernels the call launched."""

    def wrap(f):
        label = name or f.__name__

        @functools.wraps(f)
        def inner(*a, **kw):
            _cuda_sync()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            _cuda_sync()
            print(f"[time] {label}: {time.perf_counter() - t0:.4f}s")
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


class Throughput:
    """it/s and Kt/s meter with EMA smoothing."""

    def __init__(self, ctx_len: int, real_bsz: int, *, ema: float = 0.9):
        self.ctx_len = ctx_len
        self.real_bsz = real_bsz
        self.ema = ema
        self._last = None
        self._its = None

    def step(self) -> dict:
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            dt = now - self._last
            its = 1.0 / dt if dt > 0 else float("inf")
            self._its = (
                its
                if self._its is None
                else self.ema * self._its + (1 - self.ema) * its
            )
            out = {
                "it/s": self._its,
                "Kt/s": self.ctx_len * self.real_bsz * self._its / 1000.0,
            }
        self._last = now
        return out
