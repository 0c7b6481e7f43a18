"""Tensor-statistics monitor (the counterpart of ``mxtpu/monitor.py``;
reference ``python/mxnet/monitor.py``†).

``Module.install_monitor`` hooks it on the Module's executor, whose
``forward`` hands each output to the callback by name.  A statistic is
read on the host in ``toc``: a sync with the card a collected batch, a
debugging tool and not a resident of the training loop.
"""
from __future__ import annotations

import logging
import re
from typing import List, Tuple

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collect a statistic of every matching tensor each ``interval``
    batches (reference ``Monitor``†)."""

    def __init__(self, interval, stat_func=None, pattern=".*",
                 sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.abs().mean() if hasattr(x, "abs") else \
                    abs(x).mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe) -> None:
        """Hook an Executor (reference ``install``†)."""
        exe.set_monitor_callback(self._stat_helper)
        self.exes.append(exe)

    def _stat_helper(self, name, arr) -> None:
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self) -> None:
        """Start collecting for this batch (reference ``tic``†)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True

    def toc(self) -> List[Tuple[int, str, str]]:
        """Stop collecting and return ``(step, name, stat)`` rows
        (reference ``toc``†)."""
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        res = []
        queue = self.queue
        if self.sort:
            queue = sorted(queue, key=lambda x: x[1])
        for n, k, v in queue:
            res.append((n, k, str(v.asnumpy().ravel()
                                  if isinstance(v, NDArray) else v)))
        self.queue = []
        self.step += 1
        return res

    def toc_print(self) -> None:
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
