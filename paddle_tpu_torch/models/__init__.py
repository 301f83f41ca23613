from . import transformer  # noqa: F401
