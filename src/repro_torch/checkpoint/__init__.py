from . import store  # noqa: F401
