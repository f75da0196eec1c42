from .pipeline import build_step, StepOut, CompactOut  # noqa: F401
from .replay import replay, ReplayResult  # noqa: F401
