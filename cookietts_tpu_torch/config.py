"""Typed hyper-parameter configuration with CLI override grammar.

Capability-parity rebuild of the reference's three config tiers
(reference: CookieTTS/utils/utils_hparam.py, the per-vocoder JSON configs,
and the live ``run_every_epoch.py`` overlay — see SURVEY.md §5):

1. :class:`HParams` — typed named params with ``parse("a=1,b=[2,3]")``
   string-override grammar and JSON (de)serialization.
2. :func:`load_json_config` — raw JSON config files.
3. Live overlay — see :mod:`cookietts_tpu_torch.runtime.live_config`.

This is a fresh implementation; only the user-facing grammar matches the
reference (``utils_hparam.py:32-40`` documents the grammar it accepts).
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict

# One assignment name inside a comma-separated override string. Values
# are scanned by hand (bracket-balanced) so lists may nest and contain
# commas — e.g. the reference HiFi-GAN's resblock_dilations=[[1,3,5],[1,3,5]]
# (config_v1.json) — which a regex alternative cannot match.
_NAME_RE = re.compile(r"\s*(?P<name>[a-zA-Z][\w\.]*)\s*=\s*")


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    if t == "":
        return ""
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if (t[0] == t[-1] == '"') or (t[0] == t[-1] == "'"):
        return t[1:-1]
    return t


def _scan_value(s: str, pos: int) -> tuple[str, int]:
    """Scan one value starting at ``pos``: a bracket-balanced list, a
    quoted string, or a bare scalar running to the next top-level comma.
    Returns (raw_text, position_after)."""
    if pos < len(s) and s[pos] == "[":
        depth, i = 0, pos
        while i < len(s):
            if s[i] == "[":
                depth += 1
            elif s[i] == "]":
                depth -= 1
                if depth == 0:
                    return s[pos:i + 1], i + 1
            i += 1
        raise ValueError(f"Unbalanced '[' in hparam override at: {s[pos:]!r}")
    if pos < len(s) and s[pos] in "\"'":
        q, i = s[pos], pos + 1
        while i < len(s):
            if s[i] == "\\":
                i += 2
                continue
            if s[i] == q:
                return s[pos:i + 1], i + 1
            i += 1
        raise ValueError(f"Unterminated quote in hparam override at: "
                         f"{s[pos:]!r}")
    i = s.find(",", pos)
    if i < 0:
        i = len(s)
    return s[pos:i], i


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw.startswith("["):
        inner = raw[1:-1]
        items = []
        pos = 0
        while pos < len(inner):
            while pos < len(inner) and inner[pos] in ", \t\n":
                pos += 1
            if pos >= len(inner):
                break
            v, pos = _scan_value(inner, pos)
            items.append(_parse_value(v))
        return items
    return _parse_scalar(raw)


def parse_override_string(s: str) -> Dict[str, Any]:
    """Parse ``"a=1,b=[2,3],c=[[1,3],[5]],d=3.5e-4"`` into a dict."""
    out: Dict[str, Any] = {}
    pos = 0
    while pos < len(s):
        m = _NAME_RE.match(s, pos)
        if not m:
            raise ValueError(f"Could not parse hparam override at: {s[pos:]!r}")
        raw, pos = _scan_value(s, m.end())
        out[m.group("name")] = _parse_value(raw)
        # one optional separating comma, with whitespace allowed on
        # either side (trailing comma / trailing whitespace are fine)
        while pos < len(s) and s[pos] in " \t\n":
            pos += 1
        if pos < len(s):
            if s[pos] != ",":
                raise ValueError(
                    f"Expected ',' between hparam overrides at: "
                    f"{s[pos:]!r}")
            pos += 1
            while pos < len(s) and s[pos] in " \t\n":
                pos += 1
    return out


class HParams:
    """A typed, dot-accessible hyper-parameter container.

    - ``HParams(a=1, b=[2,3])`` declares params with types inferred from
      the defaults.
    - ``hp.parse("a=4,b=[9]")`` applies a CLI override string; overriding
      an undeclared name or changing a param's type raises.
    - ``hp.to_json()`` / ``HParams.from_json(s)`` round-trip via JSON.
    """

    def __init__(self, **kwargs: Any):
        object.__setattr__(self, "_params", {})
        for k, v in kwargs.items():
            self.add_hparam(k, v)

    # -- declaration ------------------------------------------------------
    def add_hparam(self, name: str, value: Any) -> None:
        if name in self._params:
            raise ValueError(f"Hyperparameter {name!r} already declared")
        self._params[name] = value

    def del_hparam(self, name: str) -> None:
        self._params.pop(name, None)

    # -- access -----------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        params = object.__getattribute__(self, "_params")
        if name in params:
            return params[name]
        raise AttributeError(f"HParams has no parameter {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._params:
            self.set_hparam(name, value)
        else:
            self.add_hparam(name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def get(self, name: str, default: Any = None) -> Any:
        return self._params.get(name, default)

    def keys(self):
        return self._params.keys()

    def values(self) -> Dict[str, Any]:
        return dict(self._params)

    # -- mutation ---------------------------------------------------------
    def set_hparam(self, name: str, value: Any) -> None:
        if name not in self._params:
            raise KeyError(f"Unknown hyperparameter {name!r}")
        old = self._params[name]
        self._params[name] = _coerce(name, value, old)

    def parse(self, override_string: str) -> "HParams":
        if override_string:
            for k, v in parse_override_string(override_string).items():
                self.set_hparam(k, v)
        return self

    def override_from_dict(self, d: Dict[str, Any]) -> "HParams":
        for k, v in d.items():
            self.set_hparam(k, v)
        return self

    # -- serialization ------------------------------------------------------
    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self._params, indent=indent, default=str)

    @classmethod
    def from_json(cls, s: str) -> "HParams":
        return cls(**json.loads(s))

    def copy(self) -> "HParams":
        return HParams(**{k: (list(v) if isinstance(v, list) else v) for k, v in self._params.items()})

    def __repr__(self) -> str:
        items = ", ".join(f"{k}={v!r}" for k, v in sorted(self._params.items()))
        return f"HParams({items})"


def _coerce(name: str, value: Any, old: Any) -> Any:
    """Type-check an override against the declared default's type."""
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() == "true"
        raise TypeError(f"{name}: expected bool, got {value!r}")
    if isinstance(old, float) and isinstance(value, (int, float)):
        return float(value)
    if isinstance(old, int) and isinstance(value, int):
        return value
    if isinstance(old, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(old, str):
        return str(value)
    if isinstance(old, (list, tuple)):
        if isinstance(value, (list, tuple)):
            return list(value)
        return [value]
    if type(old) is type(value):
        return value
    raise TypeError(f"{name}: expected {type(old).__name__}, got {type(value).__name__} ({value!r})")


def load_json_config(path: str) -> Dict[str, Any]:
    """Load a raw JSON config file (vocoder/preprocess/server config tier)."""
    with open(path) as f:
        # tolerate // comments like the reference's JSON configs
        text = re.sub(r"^\s*//.*$", "", f.read(), flags=re.MULTILINE)
    return json.loads(text)
