"""The port's kernels. Each wrapper launches its kernel on a CUDA tensor
(or raises) and computes its plain PyTorch version on a CPU tensor, and,
inside `plain_math()`, on any device.

`plain_math()` is entered only by the serving export
(bin/export_model.py): the exported program holds plain math and no
custom kernel, as JAX's export builds its model with `fused_*=False,
attention_impl="xla"` (vilco_tpu/bin/export_model.py:38-41) because Pallas
calls do not serialize, and torch.export cannot trace the kernels' ctypes
calls either. Nothing else reads it: outside the context a CUDA tensor
still launches its kernel.
"""

from __future__ import annotations

import contextlib
import contextvars

_PLAIN = contextvars.ContextVar("plain_math", default=False)


@contextlib.contextmanager
def plain_math():
    """Every kernel wrapper computes its plain version inside."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def takes_plain(t) -> bool:
    """A wrapper's choice for its input tensor `t`: the plain version on the
    CPU or inside `plain_math()`, else the kernel."""
    return t.device.type == "cpu" or _PLAIN.get()
