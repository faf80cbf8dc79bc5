"""Generic string registries.

The reference wires YAML names to classes via ``getattr(package, name)``
reflection (reference: audio_train.py:35,41,68 and
look2hear/models/__init__.py:29-56).  We make that contract explicit with a
small Registry type shared by models/datas/losses/optimizers/schedulers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator


class Registry:
    """A case-preserving name → object registry with decorator support."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None) -> Callable:
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or getattr(obj, "__name__", None)
        if key is None:
            raise ValueError(f"cannot infer a registry name for {obj!r}")
        if key in self._entries and self._entries[key] is not obj:
            raise ValueError(f"{self.kind} registry already has {key!r}")
        self._entries[key] = obj
        return obj

    def get(self, name: str) -> Any:
        if isinstance(name, str):
            if name in self._entries:
                return self._entries[name]
            # case-insensitive fallback (optimizer names are lowercase in YAML)
            lowered = {k.lower(): v for k, v in self._entries.items()}
            if name.lower() in lowered:
                return lowered[name.lower()]
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            )
        # passthrough: already a class / callable
        return name

    def __contains__(self, name: str) -> bool:
        return name in self._entries or name.lower() in {
            k.lower() for k in self._entries
        }

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def keys(self):
        return sorted(self._entries)
