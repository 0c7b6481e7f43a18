"""Training callbacks (the counterpart of ``mxtpu/callback.py``):
``Speedometer`` and ``do_checkpoint``.

``Speedometer`` logs samples/s on the host's clock: the interval
between two of its calls, which on the card includes whatever the
host waited for (each metric update syncs).  It keeps what it logged
in ``self.history``, ``(epoch, nbatch, samples/s, [(name, value)])``,
so a caller can read the numbers without parsing the log.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint"]


class Speedometer:
    """Log throughput and the running metric every ``frequent`` batches
    (reference ``Speedometer``†)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.history = []

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        name_value = []
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.history.append((param.epoch, count, speed, name_value))
        self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` every ``period`` epochs (reference
    ``do_checkpoint``†)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from . import model
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving a Module (reference†)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback
