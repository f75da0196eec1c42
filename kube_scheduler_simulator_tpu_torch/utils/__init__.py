from .quantity import parse_quantity, parse_cpu_milli, parse_memory_bytes  # noqa: F401
