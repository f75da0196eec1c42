"""Webhook extenders (extender.py) and plugin-extender hooks
(debuggable.py) for the port's engine; copies of the JAX package's
modules of the same names."""
