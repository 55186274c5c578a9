"""Timing marks between the phases of a step or a request."""

from __future__ import annotations

import time
from typing import Optional

import torch


def mark(marks: Optional[list], name: str, device) -> None:
    """Append (name, a recorded CUDA event) on the card, (name, host
    seconds) on the CPU, where `marks` is a list."""
    if marks is None:
        return
    if torch.device(device).type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    else:
        marks.append((name, time.perf_counter()))
