"""Kubernetes resource.Quantity parsing.

A copy of kube_scheduler_simulator_tpu/utils/quantity.py.

Implements the subset of apimachinery's resource.Quantity grammar that node
allocatable / pod request manifests use: plain decimals, the binary-SI
suffixes (Ki Mi Gi Ti Pi Ei) and decimal-SI suffixes (n u m k M G T P E).

CPU is canonicalised to integer millicores, memory/storage/extended
resources to integer base units, matching how the scheduler compares
requests to allocatable (upstream computes MilliCPU/Memory int64 fields in
framework.Resource; the reference feeds those through
simulator/scheduler/plugin/wrappedplugin.go:523-548 untouched).
"""

from __future__ import annotations

import functools as _functools
from fractions import Fraction

_BINARY_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIX = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 1000),
    "": Fraction(1),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def _split(s: str) -> tuple[Fraction, Fraction]:
    s = s.strip()
    if not s:
        raise ValueError("empty quantity")
    for suf, mult in _BINARY_SUFFIX.items():
        if s.endswith(suf):
            return Fraction(s[: -len(suf)]), Fraction(mult)
    # decimal suffixes are single-char; check exponent form first ("12e3")
    if s[-1] in _DECIMAL_SUFFIX and not s[-1].isdigit():
        return Fraction(s[:-1]), Fraction(_DECIMAL_SUFFIX[s[-1]])
    return Fraction(s), Fraction(1)


def parse_quantity(value) -> Fraction:
    """Parse a quantity into an exact Fraction of base units."""
    if isinstance(value, (int, float)):
        return Fraction(value)
    num, mult = _split(str(value))
    return num * mult


def parse_cpu_milli(value) -> int:
    """CPU quantity -> integer millicores (ceil, as upstream ScaledValue does)."""
    if type(value) is str:
        return _cpu_milli_str(value)
    q = parse_quantity(value) * 1000
    return int(-(-q.numerator // q.denominator))  # ceil


def parse_memory_bytes(value) -> int:
    """Memory/storage quantity -> integer bytes (ceil)."""
    if type(value) is str:
        return _memory_bytes_str(value)
    q = parse_quantity(value)
    return int(-(-q.numerator // q.denominator))


# quantity strings repeat massively across a pod queue ("1", "500m",
# "1Gi", ...); caching the string->int parse removes the Fraction
# construction from compile_workload's per-pod hot path (measured ~1s of
# a 10k-pod compile).  Strings only — int/float values skip the cache.
@_functools.lru_cache(maxsize=4096)
def _cpu_milli_str(value: str) -> int:
    q = parse_quantity(value) * 1000
    return int(-(-q.numerator // q.denominator))  # ceil


@_functools.lru_cache(maxsize=4096)
def _memory_bytes_str(value: str) -> int:
    q = parse_quantity(value)
    return int(-(-q.numerator // q.denominator))
