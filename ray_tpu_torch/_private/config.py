"""Env-overridable typed flags of the port — its own copy of the flag
registry in ``ray_tpu/_private/config.py``, holding only the flags the
port's modules read (the two LLM prefix-cache flags).

Each flag is overridable by env ``RAY_TPU_<name>``; an engine's own
``EngineConfig.prefix_cache`` overrides the flag.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    doc: str = ""


class ConfigRegistry:
    def __init__(self):
        self._flags: Dict[str, _Flag] = {}

    def declare(self, name: str, default: Any, doc: str = "") -> None:
        self._flags[name] = _Flag(name, default, type(default), doc)

    def get(self, name: str) -> Any:
        flag = self._flags[name]
        env = os.environ.get(_ENV_PREFIX + name)
        if env is None:
            return flag.default
        try:
            return _PARSERS[flag.type](env)
        except (ValueError, KeyError):
            raise ValueError(f"Bad value {env!r} for flag {name} "
                             f"(expects {flag.type.__name__})") from None


GLOBAL_CONFIG = ConfigRegistry()
_flag = GLOBAL_CONFIG.declare

# --- LLM prefix cache (llm/_prefix_cache.py) ---
_flag("llm_prefix_cache_enabled", True, "Block-granular prompt-prefix KV reuse in PagedEngine: full prompt blocks are content-hashed and refcounted across requests, so a shared-prefix request prefills only its suffix. Off = every request prefills from scratch.")
_flag("llm_prefix_cache_max_entries", 4096, "Cap on cached prefix-block entries per engine (refcounted blocks in active use are never evicted; zero-ref LRU subtrees go first). Bounds host-side cache bookkeeping, not device KV memory — the paged pool itself is the real limit.")


def get(name: str) -> Any:
    return GLOBAL_CONFIG.get(name)
