from .config import SimulatorConfiguration, load_config  # noqa: F401
