"""Backend registry and the top-level ``pmt.create`` factory.

Mirrors PMT's extensibility claim: "it can be easily extended to support
new vendors' hardware" — a new backend is one subclass plus one
``register_backend`` call.
"""
from __future__ import annotations

from typing import Dict, List, Type

_REGISTRY: Dict[str, Type] = {}


def register_backend(name: str, cls) -> None:
    """Register a Sensor subclass under ``name`` (last write wins)."""
    _REGISTRY[name] = cls


def backend_names() -> List[str]:
    """All registered backend names (available on this host or not)."""
    _ensure_builtin()
    return sorted(_REGISTRY)


def available_backend_names() -> List[str]:
    """Backends that can actually produce readings on this host.

    A backend whose ``is_available()`` itself raises (broken sysfs tree,
    driver missing mid-probe) is treated as unavailable rather than
    letting one bad backend take down enumeration for all of them.
    """
    _ensure_builtin()
    out = []
    for n, c in _REGISTRY.items():
        try:
            if c.is_available():
                out.append(n)
        except Exception:
            continue
    return sorted(out)


def get_backend(name: str):
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown PMT backend {name!r}; known: {backend_names()}") from None


def create(name: str, **kwargs):
    """``pmt.create("rapl")`` — construct a sensor by backend name.

    The Python-level analogue of ``pmt::rapl::Rapl::create()``.
    """
    return get_backend(name).create(**kwargs)


def _ensure_builtin() -> None:
    # Import built-in backends lazily so registry import never touches
    # procfs/sysfs; each backend module self-registers on import.
    if "dummy" not in _REGISTRY:
        import repro_torch.core.backends  # noqa: F401
