from .api import to_static, not_to_static, ignore_module, save, load, \
    TranslatedLayer, InputSpec  # noqa: F401
from . import dy2static, native_layer  # noqa: F401
