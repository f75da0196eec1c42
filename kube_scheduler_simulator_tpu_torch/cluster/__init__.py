from .store import ObjectStore, ApiError, RESOURCES, Conflict, NotFound, AlreadyExists  # noqa: F401
