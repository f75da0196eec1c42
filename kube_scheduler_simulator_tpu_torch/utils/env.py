"""Env-var knob parsing.

Port of kube_scheduler_simulator_tpu/utils/env.py `env_int` :15 and
`env_float` :25: unset, empty or unparsable (including "inf"/"nan" for
int knobs) falls back to the default, so an operator typo degrades to
documented behaviour instead of crashing a wave.
"""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(float(raw))
    except (ValueError, OverflowError):
        return default


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default
