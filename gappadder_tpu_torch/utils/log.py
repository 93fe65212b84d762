"""Loud, rate-limited capacity warnings (counterpart of
gappadder_tpu/utils/log.py).

Every static bound that can drop data either grows or warns through
`warn_cap`, never truncates silently. The event keys are the JAX
package's, so a test can compare the two packages' events one for one.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("gappadder_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[gappadder] %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_seen: dict[str, int] = {}


def warn_cap(key: str, msg: str, *args, every: int = 1) -> None:
    """Warn that a capacity bound did real work. ``key`` rate-limits
    repeats (the 1st occurrence, then every ``every``-th); every call
    counts, and ``cap_events`` reads the count."""
    n = _seen.get(key, 0)
    _seen[key] = n + 1
    if n % max(every, 1) == 0:
        logger.warning(msg, *args)


def cap_events(key: str) -> int:
    return _seen.get(key, 0)


def reset_cap_events() -> None:
    _seen.clear()
