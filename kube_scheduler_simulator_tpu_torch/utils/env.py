"""Env-var knob parsing.

Port of kube_scheduler_simulator_tpu/utils/env.py `env_int` :15 and
`env_float` :25 and `env_bool` :35: unset, empty or unparsable (including "inf"/"nan" for
int knobs) falls back to the default, so an operator typo degrades to
documented behaviour instead of crashing a wave.

The result path's switches, read where the JAX package reads them
(framework/replay.py:264-277 and :1346-1363, store/decode.py:36-48):

  KSS_TPU_HOST_RESIDENT=1        every replay fetches its chunks to the
                                 host in-wave (`host_resident_forced`)
  KSS_TPU_EAGER_DECODE=1         the same, for eager-decoding callers
  KSS_TPU_DEVICE_RESULT_BUDGET_MB  device bytes retained chunks may pin
                                 (`device_result_budget_bytes`)
  KSS_TPU_DISABLE_NATIVE=1       decode with the Python encoder
                                 (`native_disabled`)
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


def env_bool(name: str, default: bool) -> bool:
    """Boolean knob: "0"/"false"/"no"/"off" (any case) is False,
    "1"/"true"/"yes"/"on" is True; unset/empty/unparsable falls back."""
    raw = os.environ.get(name)
    if not raw:
        return default
    v = raw.strip().lower()
    if v in ("0", "false", "no", "off"):
        return False
    if v in ("1", "true", "yes", "on"):
        return True
    return default


def env_flag(name: str) -> bool:
    """A switch: on exactly when the variable is "1"."""
    return os.environ.get(name) == "1"


def host_resident_forced() -> bool:
    """KSS_TPU_EAGER_DECODE=1 or KSS_TPU_HOST_RESIDENT=1: the host-fetch
    rungs, bit-identical to the device-resident default."""
    return env_flag("KSS_TPU_EAGER_DECODE") or env_flag("KSS_TPU_HOST_RESIDENT")


def native_disabled() -> bool:
    """KSS_TPU_DISABLE_NATIVE=1: the Python encoder, not the native codec."""
    return env_flag("KSS_TPU_DISABLE_NATIVE")


def device_result_budget_bytes() -> int | None:
    """KSS_TPU_DEVICE_RESULT_BUDGET_MB in bytes.  Unset or negative ->
    None (no cap); 0 retains nothing; a typo ("512MB") fails safe to 0
    rather than silently lifting the cap the operator meant to set."""
    raw = os.environ.get("KSS_TPU_DEVICE_RESULT_BUDGET_MB")
    if not raw:
        return None
    try:
        mb = int(float(raw))
    except (ValueError, OverflowError):
        return 0
    return None if mb < 0 else mb * (1 << 20)
