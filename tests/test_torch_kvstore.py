"""The port's KVStore held against mxtpu's on the CPU: every case of
``tests/test_kvstore.py`` run through both stores (init/push/pull, the
parts summed, the server-side optimizer, 2-bit and 1-bit compression
with their error-feedback residuals per (key, device slot), the
parameter and guard errors), the quantizers bit for bit in f32 and bf16
over seeded pushes, the optimizer states saved and loaded, the dist
stores refused, and ``gluon.Trainer(compression_params=...)`` trained
alongside mxtpu's: the quantized gradients and the weights bit for bit
over 3 SGD steps.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import kvstore as jkv
from mxtpu import nd as jnd
from mxtpu.base import MXNetError as JMXNetError
from mxtpu.gluon import Trainer as JTrainer
from mxtpu.gluon import nn as jnn

import mxtpu_torch as tmx
from mxtpu_torch import autograd as tag
from mxtpu_torch import kvstore as tkv
from mxtpu_torch import nd as tnd
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon import Trainer as TTrainer
from mxtpu_torch.gluon import nn as tnn

from torch_gluon_names import fresh_names

CPU = tmx.cpu()


class _Side:
    """One package's store API, so each case runs once a package."""

    def __init__(self, port):
        self.port = port
        self.kv = tkv if port else jkv
        self.nd = tnd if port else jnd
        self.opt = tmx.optimizer if port else jmx.optimizer
        self.err = MXNetError if port else JMXNetError

    def array(self, a):
        a = np.asarray(a, np.float32)
        return tnd.array(a, ctx=CPU) if self.port else jnd.array(a)

    def zeros(self, shape):
        return self.array(np.zeros(shape, np.float32))

    def ones(self, shape):
        return self.array(np.ones(shape, np.float32))


SIDES = [pytest.param(False, id="mxtpu"), pytest.param(True, id="port")]


def _both(case):
    """The case's result on each store, and equal."""
    got = [case(_Side(p)) for p in (False, True)]
    np.testing.assert_equal(got[1], got[0])
    return got[1]


def test_init_push_pull():
    def case(s):
        kv = s.kv.create("local")
        kv.init(3, s.ones((2, 3)))
        out = s.zeros((2, 3))
        kv.pull(3, out=out)
        first = out.asnumpy()
        kv.push(3, s.ones((2, 3)) * 4)
        kv.pull(3, out=out)
        return first, out.asnumpy()
    first, second = _both(case)
    np.testing.assert_array_equal(first, np.ones((2, 3)))
    np.testing.assert_array_equal(second, 4 * np.ones((2, 3)))


def test_push_aggregates_parts():
    def case(s):
        kv = s.kv.create("device")
        kv.init("w", s.zeros((4,)))
        kv.push("w", [s.ones((4,)) * v for v in (1.0, 2.0, 3.0)])
        out = s.zeros((4,))
        kv.pull("w", out=out)
        return out.asnumpy()
    np.testing.assert_allclose(_both(case), 6 * np.ones(4))


def test_server_side_optimizer():
    def case(s):
        kv = s.kv.create("local")
        kv.init(0, s.ones((3,)))
        kv.set_optimizer(s.opt.SGD(learning_rate=0.1))
        kv.push(0, s.ones((3,)))       # grad 1: w -= 0.1
        out = s.zeros((3,))
        kv.pull(0, out=out)
        return out.asnumpy()
    np.testing.assert_allclose(_both(case), 0.9 * np.ones(3), rtol=1e-6)


def test_2bit_quantization_values():
    def case(s):
        kv = s.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", s.zeros((5,)))
        kv.push("g", s.array([0.9, -0.7, 0.3, -0.2, 0.0]))
        out = s.zeros((5,))
        kv.pull("g", out=out)
        return out.asnumpy()
    np.testing.assert_allclose(_both(case), [0.5, -0.5, 0.0, 0.0, 0.0])


def test_2bit_error_feedback_accumulates():
    def case(s):
        kv = s.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", s.zeros((1,)))
        out = s.zeros((1,))
        sent = []
        for _ in range(5):
            kv.push("g", s.array([0.2]))
            kv.pull("g", out=out)
            sent.append(float(out.asnumpy()[0]))
        return sent
    sent = _both(case)
    assert sent[0] == 0.0 and sent[1] == 0.0 and sent[2] == 0.5
    assert abs(sum(sent) - 1.0) <= 0.5


def test_2bit_per_slot_residuals():
    def case(s):
        kv = s.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", s.zeros((1,)))
        out = s.zeros((1,))
        sent = []
        for _ in range(3):
            kv.push("g", [s.array([0.3]), s.array([-0.4])])
            kv.pull("g", out=out)
            sent.append(float(out.asnumpy()[0]))
        return sent
    # slot 1 flushes -0.5 on the third push while slot 0 stays silent
    assert _both(case) == [0.0, 0.0, -0.5]


def test_1bit_sign_compression():
    def case(s):
        kv = s.kv.create("device")
        kv.set_gradient_compression({"type": "1bit", "threshold": 0.1})
        kv.init("g", s.zeros((3,)))
        kv.push("g", s.array([0.9, -0.7, 0.01]))
        out = s.zeros((3,))
        kv.pull("g", out=out)
        return out.asnumpy()
    np.testing.assert_allclose(_both(case), [0.1, -0.1, 0.1])


@pytest.mark.parametrize("port", SIDES)
def test_compression_rejects_bad_params(port):
    s = _Side(port)
    kv = s.kv.create("device")
    for bad in ({"type": "4bit"}, {"type": "2bit", "threshold": -1},
                {"threshold": 0.5}, {"Type": "2bit"}):
        with pytest.raises(s.err):
            kv.set_gradient_compression(bad)
    kv.set_gradient_compression({"type": "2bit"})
    assert kv._compression == {"type": "2bit", "threshold": 0.5}
    kv.set_gradient_compression(None)     # explicit None/{} disables
    assert kv._compression == {}


@pytest.mark.parametrize("port", SIDES)
def test_compression_slot_and_shape_guards(port):
    s = _Side(port)
    kv = s.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("g", s.zeros((2,)))
    kv.push("g", [s.ones((2,)), s.ones((2,))])
    with pytest.raises(s.err, match="device parts"):
        kv.push("g", s.ones((2,)))
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.push("g", s.ones((2,)))            # reset: a new slot layout
    with pytest.raises(s.err, match="shape"):
        kv.push("g", s.ones((3,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctype,thr", [("2bit", 0.5), ("1bit", 0.25),
                                       ("2bit", 0.1)])
def test_quantizers_bit_for_bit_over_pushes(ctype, thr, dtype):
    """Seeded pushes of two device parts: the sent sums and both slots'
    residuals equal mxtpu's bit for bit, in the gradients' type."""
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    parts = [[rng.randn(7, 5).astype(np.float32) * 0.3 for _ in range(2)]
             for _ in range(4)]
    got = []
    for port in (False, True):
        s = _Side(port)
        kv = s.kv.create("device")
        kv.set_gradient_compression({"type": ctype, "threshold": thr})

        def arr(a):
            if port:
                return tnd.array(a, ctx=CPU).astype(dtype)
            return jnd.array(a).astype(getattr(jnp, dtype))
        kv.init("g", arr(np.zeros((7, 5), np.float32)))
        out = arr(np.zeros((7, 5), np.float32))
        sent = []
        for step in parts:
            kv.push("g", [arr(p) for p in step])
            kv.pull("g", out=out)
            sent.append(out.asnumpy())
        res = [np.asarray(kv._residuals[("g", i)].float()
                          if port else kv._residuals[("g", i)]
                          .astype(jnp.float32)) for i in range(2)]
        got.append((sent, res))
    for a, b in zip(got[1][0] + got[1][1], got[0][0] + got[0][1]):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("port", SIDES)
def test_pushpull_row_sparse_pull_and_returned_values(port):
    s = _Side(port)
    kv = s.kv.create("local")
    kv.init(["a", "b"], [s.zeros((2,)), s.ones((3,))])
    kv.init("a", s.ones((2,)) * 9)        # a second init keeps the value
    g = s.array([1.0, 2.0])
    kv.pushpull("a", g)
    np.testing.assert_array_equal(g.asnumpy(), [1.0, 2.0])
    out = s.zeros((3,))
    kv.row_sparse_pull("b", out=out, row_ids=s.array([0]))
    np.testing.assert_array_equal(out.asnumpy(), np.ones(3))
    vals = kv.pull(["a", "b"])
    np.testing.assert_array_equal(vals[0].asnumpy(), [1.0, 2.0])
    with pytest.raises(s.err, match="not init"):
        kv.pull("c", out=s.zeros((1,)))
    with pytest.raises(s.err, match="mismatch"):
        kv.push(["a", "b"], [s.zeros((2,))])
    assert (kv.type, kv.rank, kv.num_workers) == ("local", 0, 1)
    kv.barrier()


def test_pull_writes_a_parameter_gradient_in_place():
    """A pull into ``param.grad()`` (a fresh NDArray over the gradient
    tensor) reaches the gradient the optimizer reads."""
    p = tmx.gluon.Parameter("w", shape=(3,), init="zeros")
    p.initialize(ctx=CPU)
    kv = tkv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    p.grad()._data.copy_(torch.tensor([0.7, -0.9, 0.1]))
    kv.push(0, p.grad())
    kv.pull(0, p.grad())
    np.testing.assert_array_equal(p.grad().asnumpy(), [0.5, -0.5, 0.0])


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_async"])
def test_dist_stores_refused_and_unknown_names(name):
    with pytest.raises(MXNetError, match="8b"):
        tkv.create(name)
    with pytest.raises(MXNetError, match="unknown"):
        tkv.create("foo")
    with pytest.raises(MXNetError, match="string"):
        tkv.create(3)
    for local in ("local", "device", "nccl", "local_allreduce_cpu",
                  "local_allreduce_device"):
        assert tkv.create(local).type == local
    assert tmx.kv is tkv and tmx.kvstore is tkv


def test_optimizer_states_save_and_load(tmp_path):
    kv = tkv.create("local")
    with pytest.raises(MXNetError, match="no optimizer"):
        kv.save_optimizer_states(str(tmp_path / "s"))
    kv.init(0, tnd.array(np.ones(3, np.float32), ctx=CPU))
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv.push(0, tnd.array(np.ones(3, np.float32), ctx=CPU))
    kv.save_optimizer_states(str(tmp_path / "s"))
    mom = kv._updater.states[0].clone()
    kv.push(0, tnd.array(np.ones(3, np.float32), ctx=CPU))
    kv.load_optimizer_states(str(tmp_path / "s"))
    assert torch.equal(kv._updater.states[0], mom)
    assert kv._updater.states[0].device.type == "cpu"


# ----------------------------------------------------------------------
# the Trainer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("port", SIDES)
def test_trainer_compression_without_store_raises(port):
    s = _Side(port)
    nn = tnn if port else jnn
    Trainer = TTrainer if port else JTrainer
    net = nn.Dense(1)
    net.initialize(init="zeros", **({"ctx": CPU} if port else {}))
    net(s.zeros((2, 3)))
    for kvstore in (None, "nccl"):
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=kvstore,
                          compression_params={"type": "2bit"})
        with pytest.raises(s.err, match="compression_params"):
            trainer._init_kvstore()
    bad = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                  compression_params={"type": "3bit"})
    with pytest.raises(s.err, match="unsupported"):
        bad._init_kvstore()


def test_trainer_without_compression_makes_no_store_on_one_device():
    net = tnn.Dense(1)
    net.initialize(ctx=CPU)
    net(tnd.zeros((2, 3), ctx=CPU))
    tr = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tr._init_kvstore()
    assert tr._kvstore is None
    tr2 = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                   compression_params={"type": "1bit"})
    tr2._init_kvstore()
    assert tr2._kvstore.type == "device" and \
        tr2._kvstore._compression["type"] == "1bit"


def test_trainer_makes_no_store_on_a_host_of_several_cards(monkeypatch):
    """Several cards on the host are not several devices of this
    process: without compression the default 'device' store is not
    kept, so no gradient passes through it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tkv.create("device").num_devices == 1
    net = tnn.Dense(1)
    net.initialize(ctx=CPU)
    net(tnd.zeros((2, 3), ctx=CPU))
    tr = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                  kvstore="device")
    tr._init_kvstore()
    assert tr._kvstore is None


@pytest.mark.parametrize("ctype", ["2bit", "1bit"])
def test_trainer_with_compression_bit_for_bit_with_mxtpu(ctype):
    """tests/test_kvstore.py's least-squares Trainer, three SGD steps in
    both packages from the same weights: the quantized gradients each
    step and the weights after it bit for bit."""
    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype(np.float32)
    w_true = np.array([[1.0, -2.0, 0.5, 3.0]], np.float32)
    Y = X @ w_true.T
    w0 = (rng.randn(1, 4) * 0.1).astype(np.float32)
    runs = []
    for port in (False, True):
        s = _Side(port)
        nn = tnn if port else jnn
        with fresh_names():
            net = nn.Dense(1)
        net.initialize(init="zeros", **({"ctx": CPU} if port else {}))
        x, y = s.array(X), s.array(Y)
        net(x)
        net.weight.set_data(s.array(w0))
        Trainer = TTrainer if port else JTrainer
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                     compression_params={"type": ctype,
                                         "threshold": 0.25})
        ag = tag if port else jag
        seen = []
        for _ in range(3):
            with ag.record():
                loss = s.nd.mean((net(x) - y) ** 2)
            loss.backward()
            tr.step(batch_size=1)
            seen.append((net.weight.grad().asnumpy(),
                         net.bias.grad().asnumpy(),
                         net.weight.data().asnumpy(),
                         net.bias.data().asnumpy()))
        runs.append(seen)
    for got, want in zip(runs[1], runs[0]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    # every pulled gradient is on the {-t, 0, +t} (or +-t) grid
    grads = np.concatenate([g.ravel() for step in runs[1] for g in step[:2]])
    allowed = {-0.25, 0.25} | ({0.0} if ctype == "2bit" else set())
    assert set(np.round(grads, 6).tolist()) <= allowed


def test_trainer_with_compression_trains():
    """tests/test_kvstore.py's convergence case on the port."""
    rng = np.random.RandomState(0)
    net = tnn.Dense(1)
    net.initialize(init="zeros", ctx=CPU)
    x = tnd.array(rng.randn(64, 4).astype(np.float32), ctx=CPU)
    w_true = np.array([[1.0, -2.0, 0.5, 3.0]], np.float32)
    y = tnd.array(x.asnumpy() @ w_true.T, ctx=CPU)
    net(x)
    trainer = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       compression_params={"type": "2bit",
                                           "threshold": 0.25})
    losses = []
    for _ in range(150):
        with tag.record():
            loss = tnd.mean((net(x) - y) ** 2)
        loss.backward()
        trainer.step(batch_size=1)
        losses.append(float(loss.asscalar()))
    assert min(losses) < losses[0] * 0.2, (losses[0], min(losses))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
