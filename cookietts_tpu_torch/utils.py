"""Small shared utilities (a copy of cookietts_tpu/utils.py).

Rebuild of CookieTTS/utils/_utils_.py:3-37: ``get_args`` introspects a
callable's argument names (the reference's Dataset uses this to produce
only the features the model/loss/logger signatures request) and ``force``
calls a function with only the kwargs it accepts.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, List


def get_args(func: Callable) -> List[str]:
    """Argument names of ``func`` (utils/_utils_.py:3-17)."""
    return [p for p in inspect.signature(func).parameters]


def force(func: Callable, *args: Any, **kwargs: Any) -> Any:
    """Call ``func`` with only the kwargs present in its signature
    (utils/_utils_.py:20-37)."""
    valid = set(get_args(func))
    filtered = {k: v for k, v in kwargs.items() if k in valid}
    return func(*args, **filtered)
