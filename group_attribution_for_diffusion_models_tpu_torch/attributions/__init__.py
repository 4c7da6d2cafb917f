from . import methods  # noqa: F401
