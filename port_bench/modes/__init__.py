"""The loops of the benchmark's traffic mixes: ``serve`` and ``train``.

Each mode's ``run(cell, seed, seconds, trace, device, t_start)`` sets the
cell up from the seed, measures for ``seconds``, checks what the timed path
produced against the plain reference once the window has closed, and
returns a ``Run``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class Run:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, float]  # each number compared, by name
    read: dict = field(default_factory=dict)  # what the per-layer readers read
    trace: Optional[object] = None  # trace.Trace of the traced stretch
    device: dict = field(default_factory=dict)
