"""Tracing / profiling hooks.

The reference's observability is wall-clock RTF timers and per-token decode
rates printed per run (``SenseVoice/Inference_SenseVoice_ONNX.py:289-309``,
``Whisper/Inference_Whisper_ONNX.py:835-840``) plus togglable ORT verbose
logging. Equivalents here:

- :func:`trace` — xprof/TensorBoard device trace around any code region
  (open the output dir with ``tensorboard --logdir``), the counterpart of
  ORT's profiler toggle.
- :func:`annotate` — named sub-spans that appear inside the device trace.
- :class:`StageTimer` — host-side per-stage wall-clock aggregation with an
  RTF/decode-rate report, the counterpart of the reference's printed
  timers.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile (xprof) for the enclosed region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span visible in the xprof timeline (and as XLA metadata)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Accumulate wall-clock per named stage; report totals + rates.

    >>> t = StageTimer()
    >>> with t("encode"): ...
    >>> with t("decode", items=n_tokens): ...
    >>> t.report(audio_seconds=30.0)
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.items: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1
            self.items[stage] += items

    @property
    def total_seconds(self) -> float:
        return sum(self.totals.values())

    def report(self, audio_seconds: float | None = None) -> str:
        lines = []
        for stage in self.totals:
            sec = self.totals[stage]
            line = f"{stage}: {sec:.3f}s over {self.counts[stage]} call(s)"
            if self.items[stage]:
                line += f", {self.items[stage] / max(sec, 1e-9):.1f} items/s"
            lines.append(line)
        if audio_seconds:
            lines.append(
                f"total: {self.total_seconds:.3f}s for {audio_seconds:.2f}s audio "
                f"(RTF {self.total_seconds / audio_seconds:.4f})"
            )
        return "\n".join(lines)
