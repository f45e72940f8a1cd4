"""Transient-I/O retry with exponential backoff.

Counterpart of ``paddle_tpu/distributed/checkpoint/io_retry.py``: the
export's commit and the serving engine's dispatch retries
(``ServingEngine(dispatch_retries=)``) retry a ``retry_on`` exception
with doubling sleeps before it surfaces; every retry is counted and
recorded in the flight recorder.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type, TypeVar

T = TypeVar("T")


def call_with_retries(fn: Callable[[], T], *, retries: int,
                      backoff_s: float, site: str,
                      retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                      never: Tuple[Type[BaseException], ...] = (),
                      counter=None,
                      sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn``; on a ``retry_on`` exception that is not a ``never``
    one, retry up to ``retries`` times, sleeping ``backoff_s * 2**attempt``
    between attempts.  The last failure re-raises unchanged.  ``counter``
    (an object with ``inc(site=)``, or None) counts each retry."""
    from ...observability import flight_recorder as _flight
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if isinstance(e, never) or attempt >= max(int(retries), 0):
                raise
            if counter is not None:
                counter.inc(site=site)
            _flight.default_recorder().record_event(
                "io_retry", site=site, attempt=attempt + 1,
                error=f"{type(e).__name__}: {e}"[:200])
            sleep(max(float(backoff_s), 0.0) * (2 ** attempt))
            attempt += 1
