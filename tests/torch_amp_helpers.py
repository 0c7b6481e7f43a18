"""Helpers of the AMP and int8 parity tests: the two shims that let
mxtpu's AMP and int8 passes run on jax 0.9 (this test process only;
nothing on disk changes), as a context manager and a fixture, and the
small nets whose dispatches the decision tests read.

- ``mxtpu.amp._sub_jaxprs`` tests ``isinstance(value, jax.core.Jaxpr)``;
  jax 0.9 dropped ``jax.core.Jaxpr``, so every cast and quantize
  decision comes out False and mxtpu's AMP casts nothing.  The shim
  reads ``jax.extend.core``'s ``Jaxpr`` and ``ClosedJaxpr``.
- mxtpu's AMP backward (``_dg_bwd``, ``_conv_bwd``) calls jax's private
  transposes with ``out_type`` (or without it); in jax 0.9 they take a
  required ``out_sharding`` and no ``out_type``.  The shim drops
  ``out_type`` and passes ``out_sharding=None``.

:func:`jax09_shims` applies them and clears mxtpu's decision caches on
entry and on exit, so no decision made under the shims outlives them.
"""
import contextlib

import pytest
import torch


def _decision_caches():
    from mxtpu import amp, quant
    return (amp._CAST_CACHE, quant._DECISION_CACHE)


@contextlib.contextmanager
def jax09_shims():
    import jax.extend.core as jcore
    from jax._src.lax import convolution as convmod
    from jax._src.lax import lax as laxmod
    from mxtpu import amp

    def sub_jaxprs(value):
        if isinstance(value, jcore.Jaxpr):
            yield value
        elif isinstance(value, jcore.ClosedJaxpr):
            yield value.jaxpr
        elif isinstance(value, (tuple, list)):
            for v in value:
                yield from sub_jaxprs(v)

    def without_out_type(fn):
        def shim(*args, out_type=None, out_sharding=None, **kwargs):
            return fn(*args, out_sharding=out_sharding, **kwargs)
        return shim

    patches = [(amp, "_sub_jaxprs", sub_jaxprs)]
    for mod, names in ((laxmod, ("_dot_general_transpose_lhs",
                                 "_dot_general_transpose_rhs")),
                       (convmod, ("_conv_general_dilated_transpose_lhs",
                                  "_conv_general_dilated_transpose_rhs"))):
        for name in names:
            patches.append((mod, name, without_out_type(getattr(mod, name))))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for cache in _decision_caches():
        cache.clear()
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
        for cache in _decision_caches():
            cache.clear()


@pytest.fixture
def shims():
    """mxtpu's AMP and int8 passes repaired for the test, restored
    after."""
    with jax09_shims():
        yield


def small_net(name):
    """A narrow BERT, its export's graph plan and ResNet-50 (NCHW, NHWC),
    initialized on the CPU, as a callable with its input."""
    import tempfile
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxtpu_torch.models import BERTModel, resnet50
    if name.startswith("bert"):
        net = BERTModel(64, 32, 64, 2, 2, max_length=16, dropout=0.1)
        x = torch.zeros(2, 8)
        net.initialize(ctx="cpu")
        if name == "bert":
            return net, x
        from mxtpu_torch import symbol as tsym
        from mxtpu_torch.ndarray import load_params
        from mxtpu_torch.ndarray.ndarray import NDArray
        net(x)
        with tempfile.TemporaryDirectory() as d:
            sym_file, param_file = net.export(d + "/bert")
            plan = tsym._GraphPlan(tsym.load(sym_file))
            params = load_params(param_file)
        binds = {k: NDArray(torch.tensor(v)) for k, v in params.items()}
        return (lambda data: plan.run({**binds, "data": NDArray(data)})), x
    elif name == "resnet50_NCHW":
        net, x = resnet50(classes=10), torch.zeros(1, 3, 32, 32)
    else:
        net = resnet50_v1(classes=10, layout="NHWC")
        x = torch.zeros(1, 32, 32, 3)
    net.initialize(ctx="cpu")
    return net, x
