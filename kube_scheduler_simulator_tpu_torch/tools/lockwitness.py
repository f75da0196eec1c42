"""Lock witness: a runtime lockdep for the port's chaos gate.

A copy of tools/analysis/lockwitness.py for the port, with its own cycle
finder (the SCC walk of tools/analysis/locks.py `_find_cycles`) and its
creation-site markers naming the port's paths, so a report names the
port's code (`kube_scheduler_simulator_tpu_torch/...:line`).

`install()` replaces `threading.Lock/RLock/Condition` with instrumented
factories.  Every wrapped lock records, at each successful acquisition,
an ordering edge from every lock the acquiring thread already holds to
the acquired one, building the global acquisition-order graph across
all threads of the run.  `assert_no_cycles()` then fails on any cycle:
an A->B / B->A inversion is a potential deadlock even when this
interleaving never parked, and a same-thread reacquisition of a
non-reentrant Lock is the single-lock variant.  The chaos tool
(tools/chaos.py) installs it under KSS_TPU_LOCK_WITNESS=1, before the
port creates its locks.  The wrappers are drop-in: `with`,
acquire/release with blocking/timeout, Condition wait/notify, and
`Event`/`queue.Queue` built on the patched factories keep working.

Lock identity is the creation site (file:line of the factory call), so a
report names code, not object ids.
"""

from __future__ import annotations

import threading
import traceback
import _thread

_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading._CRLock or threading._PyRLock  # type: ignore[attr-defined]
_REAL_CONDITION = threading.Condition
_ORIG_FACTORIES = (threading.Lock, threading.RLock, threading.Condition)


class LockOrderViolation(AssertionError):
    def __init__(self, cycles: list[list[str]], edges: dict):
        self.cycles = cycles
        lines = ["lock-witness: acquisition-order cycle(s) detected "
                 "(potential deadlock even if this run never parked):"]
        for cyc in cycles:
            lines.append("  cycle: " + " -> ".join([*cyc, cyc[0]]))
            for a in cyc:
                for b in cyc:
                    if (a, b) in edges:
                        threads = sorted({t for t, _n in edges[(a, b)]})
                        lines.append(f"    {a} -> {b} "
                                     f"(threads: {', '.join(threads)})")
        super().__init__("\n".join(lines))


def _creation_site() -> str:
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if "lockwitness" in fn or fn.startswith("<"):
            continue
        short = fn
        for marker in ("/kube_scheduler_simulator_tpu_torch/", "/tests/",
                       "/tools/"):
            i = fn.find(marker)
            if i >= 0:
                short = fn[i + 1:]
                break
        else:
            short = fn.rsplit("/", 1)[-1]
        return f"{short}:{frame.lineno}"
    return "?"


class Witness:
    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # (site_a, site_b) -> {(thread name, count)} — sites, not object
        # ids: two queues created on the same line are the same CLASS of
        # lock, which is what an ordering rule is about
        self.edges: dict[tuple[str, str], set] = {}
        self.violations: list[str] = []

    # ------------------------------------------------------- thread state

    def _held(self) -> list[str]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    # ---------------------------------------------------------- recording

    def on_acquire(self, site: str, reentrant: bool) -> None:
        held = self._held()
        if site in held:
            if not reentrant:
                # same-thread reacquire of a non-reentrant lock class:
                # self-deadlock unless they are distinct instances from
                # one site — record as an ordering self-edge either way
                with self._mu:
                    self.edges.setdefault((site, site), set()).add(
                        (threading.current_thread().name, 1))
            held.append(site)
            return
        if held:
            with self._mu:
                tname = threading.current_thread().name
                for h in held:
                    if h != site:
                        self.edges.setdefault((h, site), set()).add(
                            (tname, 1))
        held.append(site)

    def on_release(self, site: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                return

    # ---------------------------------------------------------- reporting

    def cycles(self) -> list[list[str]]:
        with self._mu:
            # snapshot the edge keys: background threads (commit worker,
            # server daemons) may still be acquiring witnessed locks
            # while a test teardown walks the graph
            edges = list(self.edges)
        graph: dict[str, set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        cycles = _find_cycles(graph)
        # self-edges (non-reentrant reacquire) are cycles too
        for (a, b) in edges:
            if a == b:
                cycles.append([a])
        return cycles

    def assert_no_cycles(self) -> None:
        cycles = self.cycles()
        if cycles:
            with self._mu:
                edges = dict(self.edges)
            raise LockOrderViolation(cycles, edges)

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.violations.clear()


def _find_cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """Elementary cycles via SCC decomposition (every SCC with more than
    one node, reported as the sorted node list)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[list[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


# ----------------------------------------------------------- lock wrappers


class _WitnessLockBase:
    _reentrant = False

    def __init__(self, witness: Witness, inner, site: str):
        self._w = witness
        self._inner = inner
        self._site = site

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._w.on_acquire(self._site, self._reentrant)
        return got

    def release(self):
        self._w.on_release(self._site)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # stdlib fork hooks (concurrent.futures.thread) re-init locks in
        # the child; delegate and drop any recorded hold
        self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<witnessed {self._inner!r} from {self._site}>"


class _WitnessLock(_WitnessLockBase):
    _reentrant = False


class _WitnessRLock(_WitnessLockBase):
    _reentrant = True

    # Condition integration: these are the hooks threading.Condition
    # prefers when present; wait() must drop the full recursion count
    # from the held set and restore it on wake (re-recording the edges —
    # the reacquisition after wait is a real ordering event).

    def _is_owned(self):
        return self._inner._is_owned()

    def _recursion_count(self):
        # multiprocessing's resource tracker reads it at exit (3.12)
        return self._inner._recursion_count()

    def _release_save(self):
        state = self._inner._release_save()
        count = state[0] if isinstance(state, tuple) else 1
        for _ in range(count):
            self._w.on_release(self._site)
        return state

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)
        count = state[0] if isinstance(state, tuple) else 1
        for _ in range(count):
            self._w.on_acquire(self._site, self._reentrant)


_ACTIVE: Witness | None = None


# A module that imported a factory by name while the witness was
# installed (`from threading import Lock`) keeps calling it after
# uninstall(): it then makes plain locks.


def _lock_factory():
    if _ACTIVE is None:
        return _REAL_LOCK()
    site = _creation_site()
    return _WitnessLock(_ACTIVE, _REAL_LOCK(), f"Lock@{site}")


def _rlock_factory():
    if _ACTIVE is None:
        return _REAL_RLOCK()
    site = _creation_site()
    return _WitnessRLock(_ACTIVE, _REAL_RLOCK(), f"RLock@{site}")


def _condition_factory(lock=None):
    if lock is None and _ACTIVE is not None:
        site = _creation_site()
        lock = _WitnessRLock(_ACTIVE, _REAL_RLOCK(), f"Condition@{site}")
    return _REAL_CONDITION(lock)


def install() -> Witness:
    """Patch threading's lock factories; locks created BEFORE install
    stay unwitnessed (the chaos tool installs before it imports the port).
    Returns the active Witness (idempotent)."""
    global _ACTIVE
    if _ACTIVE is not None:
        return _ACTIVE
    _ACTIVE = Witness()
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory  # type: ignore[assignment]
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    if _ACTIVE is None:
        return
    (threading.Lock, threading.RLock,
     threading.Condition) = _ORIG_FACTORIES  # type: ignore[assignment]
    _ACTIVE = None


def active() -> Witness | None:
    return _ACTIVE
