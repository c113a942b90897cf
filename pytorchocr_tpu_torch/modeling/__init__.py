from .architectures import build_model  # noqa: F401
