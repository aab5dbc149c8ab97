"""Cheap process-unique ids for API objects and claims.

``uuid.uuid4()`` costs one ``os.urandom`` syscall per id (~0.3 ms in
sandboxed containers) and sat directly on the claim-churn hot path —
profiling showed it at >20% of event-driven reconcile time. Object uids
only need process-local uniqueness, so one random prefix at import time
plus a counter gives the same 12-hex-char shape for free (and makes id
sequences reproducible within a run, which the scale benchmark and the
allocator equivalence tests like).

The port's own copy of the JAX package's ``core/uid.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

import itertools
import uuid

__all__ = ["new_uid"]

_PREFIX = uuid.uuid4().hex[:6]          # one urandom call per process
_COUNTER = itertools.count(1)


def new_uid() -> str:
    """A 12-hex-char id: random per-process prefix + monotonic counter."""
    return f"{_PREFIX}{next(_COUNTER):06x}"
