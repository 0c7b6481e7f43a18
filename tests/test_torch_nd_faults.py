"""Two ops where the port once parted from mxtpu, held against it on the
CPU: ``Pooling`` (a global "sum" is mxtpu's mean; a windowed "sum" is
the plain zero-padded window sum whatever ``count_include_pad`` says;
"lp" is sqrt of the windowed sum of squares; a pad above half the
window pads and reduces) and ``SoftmaxOutput``'s gradient with
``use_ignore`` and labels outside [0, C) (the ignored row is zero, not
an error).

The same numpy inputs (seed 0) go to both packages; outputs and
gradients agree to 1e-6 (f32, the same sums in another order).
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx

import mxtpu_torch as tmx
from mxtpu_torch import autograd

torch.set_num_threads(2)

CPU = tmx.cpu()
TOL = 1e-6

# (shape, Pooling kwargs): (a) global sum, (b) windowed sum with and
# without count_include_pad, (c) lp, (d) pads above half the window,
# plus the cases that were right before, kept right
POOL_CASES = [
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="sum", global_pool=True)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="lp", global_pool=True)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="sum", stride=(1, 1),
                        pad=(1, 1), count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="sum", stride=(2, 2),
                        pad=(1, 1), count_include_pad=True)),
    ((2, 3, 6), dict(kernel=(3,), pool_type="sum", stride=(1,), pad=(1,),
                     count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="lp", stride=(2, 2))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="lp", stride=(1, 1),
                        pad=(1, 1))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="max", stride=(1, 1),
                        pad=(2, 2))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="avg", stride=(1, 1),
                        pad=(2, 2), count_include_pad=True)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                        pad=(2, 2), count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="sum", stride=(1, 1),
                        pad=(2, 2))),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="lp", stride=(2, 2),
                        pad=(2, 2))),
    ((2, 6, 6, 3), dict(kernel=(3, 3), pool_type="sum", stride=(1, 1),
                        pad=(2, 2), layout="NHWC")),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="avg", stride=(1, 1),
                        pad=(1, 1), count_include_pad=False)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), pool_type="avg", global_pool=True)),
    ((2, 3, 6, 6), dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                        pad=(1, 1))),
]


@pytest.mark.parametrize("shape,kw", POOL_CASES,
                         ids=[f"{c[1]['pool_type']}-{i}"
                              for i, c in enumerate(POOL_CASES)])
def test_pooling_matches_mxtpu(shape, kw):
    xv = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jmx.nd.Pooling(jmx.nd.array(xv), **kw).asnumpy()
    got = tmx.nd.Pooling(tmx.nd.array(xv, ctx=CPU), **kw).asnumpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# SoftmaxOutput at (4, 5): an ignored label of -1 (the default), of C
# and inside [0, C), under each normalization; the label column holds
# the ignored label, labels in range, and (with use_ignore off) -1 and C
# outside it
C = 5
SO_LABELS = {-1.0: [-1, 0, 3, 4], float(C): [C, 1, 3, C],
             2.0: [2, 0, 2, 4]}
SO_CASES = [(ig, True, norm) for ig in SO_LABELS
            for norm in ("null", "batch", "valid")] + \
    [(-1.0, False, norm) for norm in ("null", "valid")]


@pytest.mark.parametrize("ignore_label,use_ignore,normalization", SO_CASES)
def test_softmax_output_ignored_labels_match_mxtpu(ignore_label, use_ignore,
                                                   normalization):
    rng = np.random.RandomState(0)
    xv = rng.randn(4, C).astype(np.float32) * 2
    lv = np.asarray(SO_LABELS[ignore_label], np.float32)
    kw = dict(ignore_label=ignore_label, use_ignore=use_ignore,
              normalization=normalization, grad_scale=1.5)

    jx = jmx.nd.array(xv)
    jx.attach_grad()
    with jmx.autograd.record():
        jout = jmx.nd.SoftmaxOutput(jx, jmx.nd.array(lv), **kw)
    jout.backward()

    tx = tmx.nd.array(xv, ctx=CPU)
    tx.attach_grad()
    with autograd.record():
        tout = tmx.nd.SoftmaxOutput(tx, tmx.nd.array(lv, ctx=CPU), **kw)
    tout.backward()

    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                               atol=TOL)
    grad = tx.grad.asnumpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, jx.grad.asnumpy(), rtol=0, atol=TOL)
    if use_ignore:
        assert not grad[lv == ignore_label].any()
