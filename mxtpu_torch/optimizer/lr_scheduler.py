"""Learning-rate schedulers (a copy of ``mxtpu/optimizer/
lr_scheduler.py``; reference ``python/mxnet/lr_scheduler.py``†).

A scheduler maps the optimizer's ``num_update`` to an lr.  The train
step reads it once a step (once a ``run_steps`` call) and hands the
value to the update as a Python float, so a schedule costs no launch.
``FactorScheduler`` and ``MultiFactorScheduler`` keep state (the count
they have passed), as the reference's do.
"""
from __future__ import annotations

import math

from ..base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base scheduler: maps num_update → lr, with optional linear warmup
    (reference ``lr_scheduler.LRScheduler``†)."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"bad warmup_mode {warmup_mode}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (reference
    ``FactorScheduler``†)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        if step < 1:
            raise MXNetError("step must be >= 1")
        if factor > 1.0:
            raise MXNetError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                return self.base_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given step milestones (reference
    ``MultiFactorScheduler``†)."""

    def __init__(self, step, factor=1, base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise MXNetError("steps must be increasing")
        if step and step[0] < 1:
            raise MXNetError("steps must be >= 1")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to ``final_lr`` over ``max_update`` steps
    (reference ``PolyScheduler``†)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                pow(1 - frac, self.power)
        return self.final_lr


class CosineScheduler(LRScheduler):
    """Cosine decay to ``final_lr`` over ``max_update`` steps
    (reference ``CosineScheduler``†)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            frac = (num_update - self.warmup_steps) / self.max_steps
            return self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * frac)) / 2
        return self.final_lr
