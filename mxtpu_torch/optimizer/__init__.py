"""Optimizers (``mxtpu.optimizer`` counterpart): the fourteen
optimizers and their registry, the lr schedulers, the Updater Module
drives, and the functional rules the train step runs."""
from .optimizer import (SGD, NAG, Adam, AdaGrad, AdaDelta,  # noqa: F401
                        Adamax, Nadam, RMSProp, LAMB, Ftrl, Signum, SGLD,
                        LBSGD, Test, ccSGD, Optimizer, Updater, create,
                        get_updater, register)
from . import functional, lr_scheduler  # noqa: F401
