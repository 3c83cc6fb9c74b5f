"""Structured progress logging (replaces the reference's bare couts).

Copy of ``kmer_id_tpu/utils/logging.py``.
"""

from __future__ import annotations

import sys
import time

_VERBOSITY = 1
_T0 = time.monotonic()


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = level


def log(msg: str, level: int = 1) -> None:
    if level <= _VERBOSITY:
        dt = time.monotonic() - _T0
        print(f"[kmer_id_tpu +{dt:8.2f}s] {msg}", file=sys.stderr, flush=True)
