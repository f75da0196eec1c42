"""Go time.Duration string parsing ("300ms", "1m30s", "2h45m").

A copy of kube_scheduler_simulator_tpu/utils/duration.py, host code with its
imports rewired to the port.
"""

from __future__ import annotations

import re

_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}
_TOKEN = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")


def parse_duration_seconds(value) -> float:
    """Duration -> seconds. Accepts numbers (already seconds), Go duration
    strings, and plain numeric strings."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    try:
        return float(s)
    except ValueError:
        pass
    total, pos = 0.0, 0
    for m in _TOKEN.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {value!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ValueError(f"invalid duration {value!r}")
    return total
