from .speculative import (  # noqa: F401
    replay_speculative, replay_speculative_stream, speculation_ok)
