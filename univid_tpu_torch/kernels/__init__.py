import types

from .attention import mha_reference
from . import attention


class _CallableModule(types.ModuleType):
    """`kernels.attention` names both the dispatcher module and, as in the
    JAX package (whose re-export shadows its module), the function
    `attention`: the module stays the module, and calling it calls the
    function."""

    def __call__(self, *args, **kwargs):
        return self.attention(*args, **kwargs)


attention.__class__ = _CallableModule
