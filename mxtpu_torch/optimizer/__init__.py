"""Optimizers (``mxtpu.optimizer`` counterpart): SGD and Adam, their
registry, the Updater Module drives, and the functional rules the train
step runs."""
from .optimizer import (SGD, Adam, Optimizer, Updater, create,  # noqa: F401
                        get_updater, register)
from . import functional  # noqa: F401
