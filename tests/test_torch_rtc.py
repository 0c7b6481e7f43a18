"""``mxtpu_torch.rtc`` (CudaModule, the port of TPU kernel #12) and
``mxtpu_torch.operator`` on the CPU, held against mxtpu where mxtpu has
the counterpart.

CudaModule compiles and launches only on the card (``chip_smoke.py``
runs its kernels there); here: the signature parser, the refusals
without CUDA, the port's PallasKernel refusing, ``operator.Custom``
under ``autograd.record`` with the reference's quadratic CustomOp
(forward and gradient equal to mxtpu's), and the softmax head of
``chip_smoke.py`` (the CustomOp ``softmax_rtc``) through its plain
versions: its gradient equals mxtpu's ``SoftmaxOutput`` gradient to
1e-6, and a Module trained with it follows the SoftmaxOutput Module's
trajectory (logits gradients 1e-6, parameters 1e-6 relative).
"""
import ctypes
import os
import sys

import numpy as np
import pytest
import torch

import mxtpu as jmx

import mxtpu_torch as tmx
from mxtpu_torch import MXNetError, autograd, operator, rtc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

CPU = tmx.cpu()


def test_signature_parser():
    args = rtc.parse_signature(
        "const float *x, float *y, int n, float alpha, unsigned int m, "
        "const __nv_bfloat16* __restrict__ b, long long k, double d")
    assert [a.name for a in args] == ["x", "y", "n", "alpha", "m", "b",
                                      "k", "d"]
    assert [a.is_ptr for a in args] == [True, True, False, False, False,
                                        True, False, False]
    assert args[0].dtype == args[1].dtype == torch.float32
    assert args[5].dtype == torch.bfloat16
    assert args[2].ctype is ctypes.c_int32 and args[2].kind == "int"
    assert args[3].ctype is ctypes.c_float and args[3].kind == "float"
    assert args[4].ctype is ctypes.c_uint32
    assert args[6].ctype is ctypes.c_int64
    assert args[7].ctype is ctypes.c_double
    # the names are optional, as in a C prototype
    assert rtc.parse_signature("int8_t *, size_t")[1].ctype is \
        ctypes.c_uint64
    for sig in chip_smoke.RTC_SIGNATURES.values():
        rtc.parse_signature(sig)


@pytest.mark.parametrize("bad", ["float **x", "foo *x", "float x[3]",
                                 "", "float *x,", "struct s x"])
def test_signature_parser_refuses(bad):
    with pytest.raises(MXNetError):
        rtc.parse_signature(bad)


def test_no_cuda_no_module_and_no_arrays():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(MXNetError, match="CUDA"):
        rtc.CudaModule(chip_smoke.RTC_SOURCE)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.array(np.ones(3))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.zeros((2, 2))
    s = tmx.sym.FullyConnected(tmx.sym.var("x"), num_hidden=2)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        s.simple_bind(x=(1, 3))


def test_pallas_kernel_refuses():
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasKernel(lambda x_ref, o_ref: None, out_shape=None)


def test_launch_counts_reset():
    rtc.LAUNCHES["k"] = 3
    assert rtc.launch_counts()["k"] == 3
    rtc.reset_launch_counts()
    assert rtc.launch_counts()["k"] == 0
    del rtc.LAUNCHES["k"]


def _quadratic(op_mod, name):
    """The reference's 'quadratic' CustomOp tutorial
    (``tests/test_compat_modules.py:26-66``), for ``op_mod``."""
    class Quadratic(op_mod.CustomOp):
        def __init__(self, a):
            self.a = a

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x * x * self.a)

        def backward(self, req, out_grad, in_data, out_data, in_grad,
                     aux):
            x = in_data[0]
            self.assign(in_grad[0], req[0],
                        out_grad[0] * x * (2.0 * self.a))

    @op_mod.register(name)
    class QuadraticProp(op_mod.CustomOpProp):
        def __init__(self, a="1.0"):
            super().__init__(need_top_grad=True)
            self.a = float(a)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Quadratic(self.a)


def test_custom_op_matches_mxtpu():
    import mxtpu.operator as jop
    _quadratic(jop, "quadratic_port_parity")
    _quadratic(operator, "quadratic_port_parity")
    xv = np.array([1.0, 2.0, -3.0, 0.5], np.float32)
    outs, grads = [], []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        x = mx.nd.array(xv, **kw)
        op = jop if mx is jmx else operator
        outs.append(op.Custom(x, op_type="quadratic_port_parity",
                              a="2.0").asnumpy())
        x.attach_grad()
        with mx.autograd.record():
            y = op.Custom(x, op_type="quadratic_port_parity", a="2.0")
            loss = (y * y).sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], 2 * xv * xv)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], 16 * xv ** 3, rtol=1e-6)


def test_custom_op_arrays_follow_the_inputs():
    seen = {}

    class Probe(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen["out"] = out_data[0].data
            seen["train"] = is_train
            self.assign(out_data[0], req[0], in_data[0] + 1)

        def backward(self, req, out_grad, in_data, out_data, in_grad,
                     aux):
            seen["in_grad"] = in_grad[0].data
            self.assign(in_grad[0], req[0], out_grad[0])

    @operator.register("probe_port")
    class ProbeProp(operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Probe()

    x = tmx.nd.array(np.ones((2, 3)), ctx=CPU, dtype="float64")
    x.attach_grad()
    with autograd.record():
        y = operator.Custom(x, op_type="probe_port")
    y.backward()
    assert seen["train"] is True
    assert seen["out"].dtype == seen["in_grad"].dtype == torch.float64
    assert seen["out"].device.type == "cpu"
    np.testing.assert_array_equal(x.grad.asnumpy(), np.ones((2, 3)))
    with pytest.raises(MXNetError, match="several devices"):
        operator.Custom(x, tmx.nd.NDArray(torch.ones(1, device="meta")),
                        op_type="probe_port")


def test_softmax_head_gradient_equals_softmax_output():
    chip_smoke.register_softmax_rtc()
    rng = np.random.RandomState(0)
    xv = rng.randn(16, 10).astype(np.float32) * 3
    lv = rng.randint(0, 10, 16).astype(np.float32)
    x = jmx.nd.array(xv)
    x.attach_grad()
    with jmx.autograd.record():
        out = jmx.nd.SoftmaxOutput(x, jmx.nd.array(lv))
    out.backward()
    tx = tmx.nd.array(xv, ctx=CPU)
    tx.attach_grad()
    with autograd.record():
        p = operator.Custom(tx, tmx.nd.array(lv, ctx=CPU),
                            op_type="softmax_rtc")
    p.backward()
    np.testing.assert_allclose(p.asnumpy(), out.asnumpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.asnumpy(), x.grad.asnumpy(), rtol=0,
                               atol=1e-6)
    # the port's SoftmaxOutput op agrees too, and ignores head gradients
    sx = tmx.nd.array(xv, ctx=CPU)
    sx.attach_grad()
    with autograd.record():
        so = tmx.nd.SoftmaxOutput(sx, tmx.nd.array(lv, ctx=CPU))
    so.backward(tmx.nd.array(rng.randn(16, 10), ctx=CPU))
    np.testing.assert_allclose(sx.grad.asnumpy(), x.grad.asnumpy(), rtol=0,
                               atol=1e-6)


def test_softmax_head_module_follows_softmax_output():
    """resnet8 on the CPU: a Module ending at the logits trained through
    the softmax_rtc head (forward, Custom under record, backward with
    the logits gradient, update) against the SoftmaxOutput Module, three
    SGD steps from equal parameters."""
    chip_smoke.register_softmax_rtc()
    B = 8
    sym = chip_smoke.resnet_cifar(tmx, 10, 8)
    shapes = ([("data", (B, 3, 32, 32))], [("softmax_label", (B,))])
    so = tmx.mod.Module(sym, context=CPU)
    so.bind(*shapes)
    tmx.random.seed(0)
    so.init_params(tmx.init.Xavier())
    head = tmx.mod.Module(sym.get_internals()["fc_output"], context=CPU,
                          label_names=[])
    head.bind(*shapes)
    head.set_params(*so.get_params())
    sgd = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 1.0 / B}
    for m in (so, head):
        m.init_optimizer(optimizer="sgd", optimizer_params=sgd)
    rng = np.random.RandomState(1)
    for step in range(3):
        X = rng.rand(B, 3, 32, 32).astype(np.float32)
        y = rng.randint(0, 10, B).astype(np.float32)
        batch = tmx.io.DataBatch([tmx.nd.array(X, ctx=CPU)],
                                 [tmx.nd.array(y, ctx=CPU)])
        so.forward_backward(batch)
        p_so = so.get_outputs()[0].data
        so.update()
        p, g = chip_smoke.rtc_head_step(tmx, head, batch)
        want = chip_smoke.rtc_plain("softmax_bwd", p_so, torch.tensor(y))
        assert float((g.data - want).abs().max()) <= 1e-6
        assert float((p.data.detach() - p_so).abs().max()) <= 1e-6
    assert chip_smoke.params_rel(head.get_params()[0],
                                 so.get_params()[0]) <= 1e-6


def test_autograd_api_on_ndarrays():
    x = tmx.nd.array([[1.0, 2.0], [3.0, 4.0]], ctx=CPU)
    x.attach_grad()
    assert not autograd.is_recording()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        y = (x * x + 2 * x).sum()
        with autograd.pause():
            assert not autograd.is_recording()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * x.asnumpy() + 2)
    # grad_req="add" accumulates, "write" replaces
    x.attach_grad("add")
    for _ in range(2):
        with autograd.record():
            y = (x * 3).sum()
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), np.full((2, 2), 6.0))
    with autograd.record():
        z = (x * x).sum()
    (g,) = [autograd.grad(z, [x])][0]
    np.testing.assert_allclose(g.asnumpy(), 2 * x.asnumpy())

    class Cube(autograd.Function):
        def forward(self, a):
            self.save_for_backward(a)
            return a * a * a

        def backward(self, dy):
            (a,) = self.saved_tensors
            return dy * 3 * a * a

    x.attach_grad()
    with autograd.record():
        c = Cube()(x)
    c.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 3 * x.asnumpy() ** 2)
    with pytest.raises(MXNetError, match="not produced under"):
        tmx.nd.array([1.0], ctx=CPU).backward()


def test_ndarray_save_load_cross_mxtpu(tmp_path):
    rng = np.random.RandomState(2)
    arrays = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randint(0, 9, 5).astype(np.int32)}
    for fname in ("x.params", "x.nd"):
        tmx.nd.save(str(tmp_path / ("t" + fname)),
                    {k: tmx.nd.array(v, ctx=CPU) for k, v in arrays.items()})
        jmx.nd.save(str(tmp_path / ("j" + fname)),
                    {k: jmx.nd.array(v) for k, v in arrays.items()})
        for src, loader in (("t", jmx.nd.load), ("j",
                                                 lambda f: tmx.nd.load(
                                                     f, ctx=CPU))):
            got = loader(str(tmp_path / (src + fname)))
            for k, v in arrays.items():
                np.testing.assert_array_equal(got[k].asnumpy(), v)
    assert (tmp_path / "tx.params").read_bytes() == \
        (tmp_path / "jx.params").read_bytes()
    assert (tmp_path / "tx.nd").read_bytes()[:8] == b"MXTPU01\n"
    lst = [tmx.nd.array(v, ctx=CPU) for v in arrays.values()]
    tmx.nd.save(str(tmp_path / "l.nd"), lst)
    got = jmx.nd.load(str(tmp_path / "l.nd"))
    assert isinstance(got, list) and len(got) == 2
