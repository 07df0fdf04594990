"""Explicit class registry for config-driven dispatch (counterpart of
``rsl_rl_tpu/utils/registry.py``): config strings name registered classes,
never ``eval``."""

from __future__ import annotations

from typing import Any, Callable

_REGISTRIES: dict[str, dict[str, Any]] = {"policy": {}, "algorithm": {}}


def register(kind: str, name: str | None = None) -> Callable:
    """Class decorator registering ``cls`` under ``kind``/``name``."""

    def deco(cls):
        _REGISTRIES.setdefault(kind, {})[name or cls.__name__] = cls
        return cls

    return deco


def resolve(kind: str, name_or_cls: str | type) -> Any:
    """Look up a registered class by name, or pass a class through."""
    if not isinstance(name_or_cls, str):
        return name_or_cls
    registry = _REGISTRIES.get(kind, {})
    if name_or_cls not in registry:
        raise ValueError(
            f"Unknown {kind} class '{name_or_cls}'. Registered: {sorted(registry)}."
        )
    return registry[name_or_cls]
