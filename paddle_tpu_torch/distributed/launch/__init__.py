from .main import main  # noqa: F401
