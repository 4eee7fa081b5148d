"""String-keyed head registry: ``get("screened-cuda", W=W, b=b, screen=s)``.

Twin of ``repro/heads/registry.py``. Factories receive the construction
context as keyword arguments — at minimum ``W`` and ``b``; screening heads
also need ``screen`` — and tolerate extras (``**_``) so one context dict can
build every head. ``get`` places the context on ``device`` first.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.device import resolve_device
from repro_torch.heads.base import SoftmaxHead

_REGISTRY: Dict[str, Callable[..., SoftmaxHead]] = {}


def register(name: str, factory: Callable[..., SoftmaxHead]):
    """Register a head factory: ``register("my-head", lambda W, b, **_:
    MyHead(W, b))``."""
    _REGISTRY[name] = factory
    return factory


def get(name: str, device="cuda", **context) -> SoftmaxHead:
    """Build + ``prepare()`` the head registered under ``name`` on
    ``device`` ("cuda" by default; raises without a GPU unless the caller
    passes device="cpu"). ``W``/``b`` may be tensors or arrays; a
    ``screen`` is moved to the device."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown head {name!r}; registered: {names()}")
    dev = resolve_device(device)
    for key in ("W", "b"):
        if key in context:
            context[key] = torch.as_tensor(context[key], device=dev)
    if context.get("screen") is not None:
        context["screen"] = context["screen"].to(dev)
    return _REGISTRY[name](**context).prepare()


def names() -> List[str]:
    return sorted(_REGISTRY)
