"""Lock factories for the core modules.

The JAX package routes these through its runtime lock sanitizer; the port
has no sanitizer yet, so they are the plain ``threading`` constructors.
Keeping the factory names lets the copied core modules stay line-for-line
with their counterparts.
"""
from __future__ import annotations

import threading


def new_lock(name: str = "anonymous.Lock") -> threading.Lock:
    del name
    return threading.Lock()


def new_rlock(name: str = "anonymous.RLock") -> threading.RLock:
    del name
    return threading.RLock()


def new_condition(lock=None, name: str = "anonymous.Condition"):
    del name
    return threading.Condition(lock)
