from .mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    shard_workload,
    sharded_step,
    speculative_scores,
)
from .speculative import (  # noqa: F401
    replay_speculative, replay_speculative_stream, speculation_ok)
