from .annotations import *  # noqa: F401,F403
from .decode import (  # noqa: F401
    decode_all, decode_all_parallel, decode_chunk_into, decode_pod_result,
    decode_release_batches)
