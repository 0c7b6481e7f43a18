"""Gluon activation layers (the counterpart of
``mxtpu/gluon/nn/activations.py``) on the ``Activation`` and
``LeakyReLU`` ops."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish"]


class Activation(HybridBlock):
    """Elementwise activation by name (reference ``nn.Activation``†)."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class LeakyReLU(HybridBlock):
    """``max(x, alpha * x)`` (reference ``nn.LeakyReLU``†)."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    """A learned leaky slope (reference ``nn.PReLU``†)."""

    def __init__(self, alpha_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        self.alpha = self.params.get("alpha", shape=(1,),
                                     init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """Exponential linear unit (reference ``nn.ELU``†)."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (reference ``nn.SELU``†)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """Gaussian error linear unit, tanh form (reference ``nn.GELU``†)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference ``nn.Swish``†)."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
