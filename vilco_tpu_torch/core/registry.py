"""Name -> factory registries.

One generic registry replaces the reference's per-kind register_* functions
(MQ/libs/modeling/models.py:5-49, MQ/libs/datasets/datasets.py:5-17).

A copy of vilco_tpu/core/registry.py: the same code,
its imports pointed at the port (which imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str):
        def deco(fn):
            if name in self._entries:
                raise KeyError(f"duplicate {self.kind} '{name}'")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} '{name}'; have {sorted(self._entries)}"
            )
        return self._entries[name]

    def make(self, name: str, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


DATASETS = Registry("dataset")
MODELS = Registry("model")
TASKS = Registry("task")
CL_METHODS = Registry("cl_method")
