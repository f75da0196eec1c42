"""Bounded concurrent fan-out with first-error propagation.

Capability parity with the reference's SemaphoredErrGroup (reference:
simulator/util/semaphored_errgroup.go:17-41 — an errgroup whose Go()
acquires one of GOMAXPROCS semaphore permits), used for snapshot
list/apply fan-out and etcd restore (snapshot.go:103-136,
reset/reset.go:63-78).

A copy of kube_scheduler_simulator_tpu/utils/errgroup.py.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor


class SemaphoredErrGroup:
    def __init__(self, limit: int | None = None):
        self._pool = ThreadPoolExecutor(max_workers=limit or os.cpu_count() or 4)
        self._futures: list[Future] = []

    def go(self, fn, *args, **kwargs) -> None:
        """Submit fn; at most `limit` run at once (pool-bounded, so a
        100k-object snapshot does not spawn 100k OS threads)."""
        self._futures.append(self._pool.submit(fn, *args, **kwargs))

    def wait(self) -> None:
        """Block until all submitted work finishes; re-raise the FIRST
        error in submission order (errgroup.Wait)."""
        futures, self._futures = self._futures, []
        first_err: BaseException | None = None
        for f in futures:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 — errgroup captures all
                if first_err is None:
                    first_err = e
        self._pool.shutdown(wait=True)
        if first_err is not None:
            raise first_err
