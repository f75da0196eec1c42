from .resources import ResourceSchema, pod_resource_request  # noqa: F401
from .nodes import NodeTable  # noqa: F401
from .compile import CompiledWorkload, compile_workload  # noqa: F401
