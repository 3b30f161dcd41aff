"""Hook machinery: extensible event and context hooks around program calls
(reference: src/gt4py/next/instrumentation/hook_machinery.py:54,153,167).

Copied from gt4py_tpu/instrumentation/hooks.py; imports renamed. The JAX
package's compile events (``stencil_compile_start``/``_end``), which
nothing fires, are left out: the build's phases are spans (spans.py).
``stencil_call`` wraps each call of a stencil or field operator: the
runtime's root span runs its hooks (``hook=``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable


class EventHook:
    """Registry of callbacks fired at a named event."""

    def __init__(self, name: str):
        self.name = name
        self.callbacks: list[Callable] = []

    def register(self, fn: Callable) -> Callable:
        self.callbacks.append(fn)
        return fn

    def fire(self, *args: Any, **kwargs: Any) -> None:
        for fn in self.callbacks:
            fn(*args, **kwargs)


class ContextHook:
    """Registry of context managers wrapping a named phase."""

    def __init__(self, name: str):
        self.name = name
        self.factories: list[Callable] = []

    def register(self, factory: Callable) -> Callable:
        self.factories.append(factory)
        return factory

    @contextmanager
    def wrap(self, *args: Any, **kwargs: Any):
        managers = [f(*args, **kwargs) for f in self.factories]
        for m in managers:
            m.__enter__()
        try:
            yield
        finally:
            for m in reversed(managers):
                m.__exit__(None, None, None)


_event_hooks: dict[str, EventHook] = {}
_context_hooks: dict[str, ContextHook] = {}


def event_hook(name: str) -> EventHook:
    if name not in _event_hooks:
        _event_hooks[name] = EventHook(name)
    return _event_hooks[name]


def context_hook(name: str) -> ContextHook:
    if name not in _context_hooks:
        _context_hooks[name] = ContextHook(name)
    return _context_hooks[name]


def register_event_hook(name: str):
    return event_hook(name).register


def register_context_hook(name: str):
    return context_hook(name).register


# Standard hook point (reference: ffront/decorator.py:62-83).
stencil_call = context_hook("stencil_call")
