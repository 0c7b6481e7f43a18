"""Optimizers (``mxtpu.optimizer`` counterpart): SGD and Adam, their
registry, and the functional rules the train step runs."""
from .optimizer import (SGD, Adam, Optimizer, create,  # noqa: F401
                        register)
from . import functional  # noqa: F401
