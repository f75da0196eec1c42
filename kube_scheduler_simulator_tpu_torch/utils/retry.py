"""Retry with exponential backoff.

A copy of kube_scheduler_simulator_tpu/utils/retry.py, host code with its
imports rewired to the port.

Same schedule as the reference's util.RetryWithExponentialBackOff
(reference: simulator/util/retry.go:10-27): initial 100ms, factor 3.0,
6 steps.  fn returns (done, error): done=True stops; an error aborts;
(False, None) retries after the next backoff.

The full schedule sleeps up to ~36s.  A caller being torn down
(session eviction, server shutdown — server/sessions.py) must not ride
that out: pass `stop` (a threading.Event) and the in-flight backoff
wakes the moment it fires, raising RetryAborted instead of sleeping
the teardown through the remaining steps.
"""

from __future__ import annotations

import time
from typing import Callable

INITIAL_DURATION = 0.1
FACTOR = 3.0
STEPS = 6


class RetryTimeout(Exception):
    pass


class RetryAborted(RetryTimeout):
    """The caller's stop event fired mid-retry: the condition was
    neither met nor refuted — the owner is shutting down.  A subclass
    of RetryTimeout so existing exhaustion handling applies."""


def retry_with_exponential_backoff(fn: Callable[[], tuple[bool, Exception | None]],
                                   sleep=time.sleep, stop=None) -> None:
    delay = INITIAL_DURATION
    for step in range(STEPS):
        if stop is not None and stop.is_set():
            raise RetryAborted("retry interrupted by stop event")
        done, err = fn()
        if err is not None:
            raise err
        if done:
            return
        if step < STEPS - 1:
            if stop is not None and sleep is time.sleep:
                # interruptible wait: wakes the instant stop fires
                if stop.wait(delay):
                    raise RetryAborted("retry interrupted by stop event")
            else:
                # injected sleeps (tests) keep their call schedule; the
                # stop check after still bounds a set-mid-sleep teardown
                sleep(delay)
                if stop is not None and stop.is_set():
                    raise RetryAborted("retry interrupted by stop event")
            delay *= FACTOR
    raise RetryTimeout("timed out waiting for the condition")
