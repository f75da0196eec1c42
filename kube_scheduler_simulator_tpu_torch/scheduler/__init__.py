"""The scheduler's configuration service (service.py, convert.py),
webhook extenders (extender.py) and plugin-extender hooks
(debuggable.py, external.py) for the port's engine; copies of the JAX
package's modules of the same names."""

from .service import SchedulerService  # noqa: F401,E402
from .convert import (  # noqa: F401,E402
    convert_configuration_for_simulator,
    default_scheduler_config,
    parse_plugin_set,
)
