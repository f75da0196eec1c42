from .annotations import *  # noqa: F401,F403
from .decode import decode_pod_result, decode_all  # noqa: F401
