from .registry import PLUGIN_REGISTRY, default_plugin_names  # noqa: F401
