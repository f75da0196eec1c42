"""Hand-written CUDA kernels of the port: build (build.py) and wrappers
(step.py, spec.py, attribution.py, gang.py, phased.py).  Nothing here imports a compiler or loads a library at import
time; both happen on first use on the card."""
