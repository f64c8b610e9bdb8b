"""Named stages of a render, a training step or the training CLI, timed on
the device when asked.

`span(name)` wraps one stage. While no `SpanTimer` is
active it only reads one module global. Inside `with SpanTimer() as timer:`
each span records a CUDA event on the current stream where its stage starts
and another where it ends, and `timer.ms()` sums, per name, the device
timeline between the two: the stage's kernels and the device's idle gaps
between them, which is what the stage costs a request while the device
waits on the host; for a stage of host work alone (a file parsed, a PNG
encoded) with the device idle, that is its time on the host's clock.
Recording synchronises nothing; `ms()` synchronises once. `chip_smoke.py`
reads the spans in its profile, train and CLI phases.
"""
import contextlib
from typing import Dict, List, Optional, Tuple

import torch

_active: Optional["SpanTimer"] = None


@contextlib.contextmanager
def span(name: str):
    timer = _active
    if timer is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    timer.events.append((name, start, end))


class SpanTimer:
    """Collects the spans recorded while it is active (CUDA only)."""

    def __init__(self):
        self.events: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def __enter__(self) -> "SpanTimer":
        global _active
        if _active is not None:
            raise RuntimeError("a SpanTimer is already active")
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None

    def ms(self) -> Dict[str, Tuple[float, int]]:
        """Per span name: (device ms summed over its spans, number of spans)."""
        torch.cuda.synchronize()
        out: Dict[str, Tuple[float, int]] = {}
        for name, start, end in self.events:
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + start.elapsed_time(end), n + 1)
        return out
