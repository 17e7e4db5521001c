from .server import ViewerServer  # noqa: F401
