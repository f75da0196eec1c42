from .di import DIContainer  # noqa: F401
from .server import SimulatorServer  # noqa: F401
from .sessions import SessionManager, SimulationSession  # noqa: F401
