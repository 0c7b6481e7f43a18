"""mxtpu_torch's symbolic graphs held against mxtpu's: the op-parameter
coercion, the networks of ``examples/train_cifar10.py`` (resnet8,
resnet20) and ``examples/module_mlp.py`` built with each package's
``sym`` (argument, auxiliary and output lists, inferred shapes, the
JSON text byte for byte), and ``-symbol.json`` crossing both ways.

The example modules build their networks through a module-level ``mx``;
the tests point it at each package in turn, so both graphs come from
the same code.  mxtpu's ``sym.Activation(sym.BatchNorm(x))`` raises
(a multi-output symbol must be indexed), while the port composes by
BatchNorm's output 0 as the reference does; mxtpu's side therefore
builds with ``BatchNorm(...)[0]``, which is the same graph.  Auto-named
nodes (``activation0``, ``_plus0``...) count per process, so each build
starts from fresh name counters on both sides.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import mxtpu
import mxtpu.symbol as jsym
from mxtpu.ops.params import Param as JParam

import mxtpu_torch
import mxtpu_torch.symbol as tsym
from mxtpu_torch import MXNetError
from mxtpu_torch.ops import Param, ParamSet, get_op, list_ops

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
import module_mlp  # noqa: E402
import train_cifar10  # noqa: E402

torch.set_num_threads(2)

NETS = ["resnet8", "resnet20", "mlp"]
DATA = {"resnet8": (4, 3, 32, 32), "resnet20": (4, 3, 32, 32),
        "mlp": (4, 20)}


class _IndexedBN:
    """mxtpu's ``sym`` with ``BatchNorm`` taking output 0."""

    def __getattr__(self, name):
        if name == "BatchNorm":
            return lambda *a, **k: jsym.BatchNorm(*a, **k)[0]
        return getattr(jsym, name)


class _MX:
    def __init__(self, sym):
        self.sym = sym


def build(pkg, net, monkeypatch):
    """``net`` built by the example's own code with ``pkg`` ("mxtpu" or
    "port") as its ``mx``, from fresh auto-name counters."""
    monkeypatch.setattr(jsym, "_NAME_COUNTERS", {})
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
    mx = _MX(_IndexedBN()) if pkg == "mxtpu" else mxtpu_torch
    mod = module_mlp if net == "mlp" else train_cifar10
    monkeypatch.setattr(mod, "mx", mx)
    if net == "mlp":
        return module_mlp.build_symbol()
    return train_cifar10.NETWORKS[net](num_classes=10)


def shapes(net):
    return {"data": DATA[net], "softmax_label": DATA[net][:1]}


@pytest.mark.parametrize("net", NETS)
def test_graphs_equal_mxtpu(net, monkeypatch):
    j = build("mxtpu", net, monkeypatch)
    t = build("port", net, monkeypatch)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs() == ["softmax_output"]
    assert t.infer_shape(**shapes(net)) == j.infer_shape(**shapes(net))
    assert t.tojson() == j.tojson()
    assert t.attr_dict() == j.attr_dict()
    if net == "resnet20":
        # 19 BatchNorms, 19 3x3 convolutions and 2 1x1 shortcuts
        ops = [n["op"] for n in json.loads(t.tojson())["nodes"]]
        assert ops.count("BatchNorm") == 19
        assert ops.count("Convolution") == 21
        assert len(t.list_auxiliary_states()) == 38


@pytest.mark.parametrize("net", NETS)
def test_json_crosses_both_ways(net, monkeypatch, tmp_path):
    j = build("mxtpu", net, monkeypatch)
    t = build("port", net, monkeypatch)
    j.save(str(tmp_path / "j-symbol.json"))
    t.save(str(tmp_path / "t-symbol.json"))
    from_j = tsym.load(str(tmp_path / "j-symbol.json"))
    from_t = jsym.load(str(tmp_path / "t-symbol.json"))
    assert from_j.tojson() == j.tojson()
    assert from_t.tojson() == t.tojson()
    for a, b in ((from_j, j), (from_t, t)):
        assert a.list_arguments() == b.list_arguments()
        assert a.list_auxiliary_states() == b.list_auxiliary_states()
        assert a.list_outputs() == b.list_outputs()
    assert from_j.infer_shape(**shapes(net)) == j.infer_shape(**shapes(net))


def test_batchnorm_composes_by_output_zero(monkeypatch):
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
    x = tsym.var("x")
    bn = tsym.BatchNorm(x, name="bn")
    assert bn.list_outputs() == ["bn_output0", "bn_output1", "bn_output2"]
    assert bn.list_outputs() == jsym.BatchNorm(jsym.var("x"),
                                               name="bn").list_outputs()
    a = tsym.Activation(bn, act_type="relu")
    b = tsym.Activation(bn[0], act_type="relu", name="activation0")
    assert a.tojson() == b.tojson()
    with pytest.raises(mxtpu.MXNetError, match="multi-output"):
        jsym.Activation(jsym.BatchNorm(jsym.var("x")), act_type="relu")
    # output_mean_var shows all three outputs: indexing is required
    with pytest.raises(MXNetError, match="multi-output"):
        tsym.Activation(tsym.BatchNorm(x, output_mean_var=True))
    with pytest.raises(MXNetError, match="multi-output"):
        tsym.Activation(tsym.Group([x, x]))


def test_operators_and_scalars_match_mxtpu(monkeypatch):
    outs = []
    for s in (jsym, tsym):
        monkeypatch.setattr(s, "_NAME_COUNTERS", {})
        a, b = s.var("a"), s.var("b")
        c = (a + b) * 2.0 - 1 / a + (b ** 2) - a / b
        outs.append(s.Group([c, -a, a > b, a.reshape((2, -1))]))
    assert outs[0].tojson() == outs[1].tojson()
    assert outs[0].list_outputs() == outs[1].list_outputs()
    assert outs[1].infer_shape(a=(2, 3), b=(2, 3))[1] == \
        [(2, 3), (2, 3), (2, 3), (2, 3)]


def test_eval_and_bind_on_the_cpu():
    a, b = tsym.var("a"), tsym.var("b")
    c = tsym.FullyConnected(a * b + 1.0, num_hidden=3, name="fc")
    rng = np.random.RandomState(0)
    av, bv = rng.randn(2, 4).astype(np.float32), \
        rng.randn(2, 4).astype(np.float32)
    w, bias = rng.randn(3, 4).astype(np.float32), \
        rng.randn(3).astype(np.float32)
    nd = mxtpu_torch.nd
    cpu = mxtpu_torch.cpu()
    args = {"a": nd.array(av, ctx=cpu), "b": nd.array(bv, ctx=cpu),
            "fc_weight": nd.array(w, ctx=cpu), "fc_bias": nd.array(bias,
                                                                   ctx=cpu)}
    want = (av * bv + 1.0) @ w.T + bias
    got = c.eval(**args)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ex = c.bind(ctx=cpu, args=args)
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), want, rtol=1e-6,
                               atol=1e-6)
    ex = c.simple_bind(ctx=cpu, a=(2, 4), b=(2, 4))
    assert ex.arg_dict["fc_weight"].shape == (3, 4)
    assert ex.grad_dict["fc_bias"].shape == (3,)


def test_infer_shape_needs_every_input():
    s = tsym.SoftmaxOutput(tsym.FullyConnected(tsym.var("data"),
                                               num_hidden=4), name="sm")
    with pytest.raises(MXNetError, match="sm_label"):
        s.infer_shape(data=(2, 3))
    args, outs, _ = s.infer_shape_partial(data=(2, 3))
    assert args == [(2, 3), (4, 3), (4,), None] and outs == [None]


def test_registry_covers_the_path():
    names = set(list_ops())
    for op in ("Convolution", "BatchNorm", "Activation", "Pooling",
               "Flatten", "FullyConnected", "SoftmaxOutput",
               "broadcast_add", "_plus_scalar", "_rminus_scalar"):
        assert op in names or get_op(op).name in names, op
    assert get_op("elemwise_add") is get_op("broadcast_add")
    assert get_op("flatten") is get_op("Flatten")
    assert get_op("Convolution").infer(
        (2, 3, 8, 8), (4, 3, 3, 3), kernel=(3, 3), num_filter=4,
        pad=(1, 1), no_bias=True) == [(2, 4, 8, 8)]
    assert get_op("BatchNorm").infer((2, 4, 5, 5), (4,), (4,), (4,),
                                     (4,)) == [(2, 4, 5, 5), (4,), (4,)]


# -------------------------------------------------------- Param coercion

CASES = [
    (dict(name="kernel", dtype=tuple, default=()), "(3, 3)", (3, 3)),
    (dict(name="kernel", dtype=tuple, default=()), "[1, 2]", (1, 2)),
    (dict(name="kernel", dtype=tuple, default=()), 5, (5,)),
    (dict(name="kernel", dtype=tuple, default=()), [2, 2], (2, 2)),
    (dict(name="axis", dtype=tuple, default=None), "1", (1,)),
    (dict(name="no_bias", dtype=bool, default=False), "False", False),
    (dict(name="no_bias", dtype=bool, default=False), "true", True),
    (dict(name="no_bias", dtype=bool, default=False), "1", True),
    (dict(name="no_bias", dtype=bool, default=False), 0, False),
    (dict(name="num_filter", dtype=int, default=0), "16", 16),
    (dict(name="eps", dtype=float, default=1e-5), "0.001", 0.001),
    (dict(name="eps", dtype=float, default=1e-5), 2, 2.0),
    (dict(name="act_type", dtype=str, default="relu"), "tanh", "tanh"),
    (dict(name="layout", dtype=str, default=None), None, None),
]


@pytest.mark.parametrize("spec,value,want", CASES)
def test_param_coercion_matches_mxtpu(spec, value, want):
    got = Param(**spec).validate(value)
    assert got == want and type(got) is type(want)
    assert JParam(**spec).validate(value) == got
    assert Param(**spec).serialize(got) == JParam(**spec).serialize(got)


@pytest.mark.parametrize("spec,value", [
    (dict(name="act_type", dtype=str, enum=("relu", "tanh")), "gelu"),
    (dict(name="p", dtype=float, lower=0.0, upper=1.0), "1.5"),
    (dict(name="p", dtype=float, lower=0.0, upper=1.0), -0.5),
])
def test_param_refusals_match_mxtpu(spec, value):
    with pytest.raises(MXNetError):
        Param(**spec).validate(value)
    with pytest.raises(mxtpu.MXNetError):
        JParam(**spec).validate(value)


def test_paramset_resolves_like_mxtpu():
    op = get_op("Convolution")
    attrs = {"kernel": "(3, 3)", "num_filter": "8", "no_bias": "True",
             "pad": "(1, 1)"}
    jop = mxtpu.ops.get_op("Convolution")
    assert op.resolve_params(attrs) == jop.resolve_params(attrs)
    with pytest.raises(MXNetError, match="unknown params"):
        op.resolve_params({"kernel": (3, 3), "bogus": 1})
    with pytest.raises(MXNetError, match="required"):
        ParamSet(Param("x", int)).resolve({})


# ------------------------------------------------ shape hooks and bind

def _hook_graph(s, op):
    """A graph of ``op`` over ``data`` whose weights only the op's shape
    hook can give (each package's ``sym`` as ``s``)."""
    data = s.var("data")
    if op == "Embedding":
        return s.LayerNorm(s.Embedding(data, input_dim=100, output_dim=16,
                                       name="emb"), name="ln")
    if op == "LayerNorm":
        return s.Group([s.LayerNorm(data, name="ln"),
                        s.LayerNorm(data, axis=1, name="ln1")])
    if op == "BatchNormAddRelu":
        return s.BatchNormAddRelu(data, s.var("addend"), name="bnar")
    return getattr(s, op)(data, name="n")


HOOK_OPS = {"Embedding": (4, 8), "LayerNorm": (4, 6, 10),
            "BatchNormRelu": (4, 3, 5, 5), "BatchNormAddRelu": (4, 3, 5, 5),
            "InstanceNorm": (4, 3, 5, 5)}


@pytest.mark.parametrize("op", sorted(HOOK_OPS))
def test_shape_hooks_infer_as_mxtpu(op, monkeypatch):
    monkeypatch.setattr(jsym, "_NAME_COUNTERS", {})
    monkeypatch.setattr(tsym, "_NAME_COUNTERS", {})
    j, t = _hook_graph(jsym, op), _hook_graph(tsym, op)
    assert t.tojson() == j.tojson()
    shape = HOOK_OPS[op]
    got, want = t.infer_shape(data=shape), j.infer_shape(data=shape)
    assert got == want
    args = dict(zip(t.list_arguments(), got[0]))
    if op == "Embedding":
        assert args["emb_weight"] == (100, 16) and args["ln_gamma"] == (16,)
    elif op == "LayerNorm":
        assert args["ln_gamma"] == (10,) and args["ln1_beta"] == (6,)
    elif op == "BatchNormAddRelu":
        assert args["addend"] == shape and args["bnar_gamma"] == (3,)


def test_deconvolution_waits_for_its_op():
    # the op came with its hook: both registered, the hook's shapes
    # mxtpu's (tests/test_torch_conv_layers.py holds the op itself)
    assert "Deconvolution" in jsym._INFER_HOOKS
    assert "Deconvolution" in tsym._INFER_HOOKS
    assert "Deconvolution" in list_ops()
    attrs = {"kernel": "(3, 3)", "num_filter": "6", "num_group": "2"}
    for shapes in ([(2, 4, 5, 5), None, None], [None, None]):
        assert tsym._INFER_HOOKS["Deconvolution"](shapes, attrs) == \
            jsym._INFER_HOOKS["Deconvolution"](shapes, attrs)


@pytest.fixture(scope="module")
def bert_export(tmp_path_factory):
    """mxtpu's 2-layer BERT export (the graph a deployment ships)."""
    from mxtpu import nd as jnd
    from mxtpu.models.transformer import BERTModel as JBERT
    from tests.torch_gluon_names import fresh_names
    with fresh_names():
        net = JBERT(128, 64, 256, 2, 4, max_length=40, dropout=0.1)
    net.initialize(init="xavier")
    net(jnd.array(np.zeros((1, 8), np.float32)))
    return net.export(str(tmp_path_factory.mktemp("bert") / "bert"))


@pytest.mark.parametrize("known", [{}, {"bertmodel0_pos_embed": (40, 64)}])
def test_bert_export_infers_as_mxtpu(bert_export, known):
    """From the data shape alone mxtpu infers the word embedding and no
    more: the positional table's length is nowhere in the graph
    (``expand_dims``/``slice_like`` have no hook) and the fused
    residual LayerNorm has no hook.  Given the table, the first layer's
    LayerNorm and attention weights follow.  The port infers exactly
    what mxtpu does, partial shapes included."""
    j, t = jsym.load(bert_export[0]), tsym.load(bert_export[0])
    shapes = dict(data=(4, 8), **known)
    got = t.infer_shape_partial(**shapes)
    assert got == j.infer_shape_partial(**shapes)
    args = dict(zip(t.list_arguments(), got[0]))
    assert args["embedding0_weight"] == (128, 64)
    if known:
        assert args["layernorm0_gamma"] == (64,)
        assert args["dense0_weight"] == (192, 64)
        assert args["dense1_weight"] == (64, 64)
    assert args["fusedresiduallayernorm0_gamma"] is None
    with pytest.raises(mxtpu.MXNetError, match="could not infer") as je:
        j.infer_shape(**shapes)
    with pytest.raises(MXNetError, match="could not infer") as te:
        t.infer_shape(**shapes)
    assert str(te.value).split("—")[0] == str(je.value).split("—")[0]


def test_module_bind_from_data_shapes_as_mxtpu(bert_export):
    """``Module.bind`` from data_shapes alone: the Embedding ->
    LayerNorm graph binds, each weight as mxtpu binds it; the BERT
    export stops in both packages at the same unknown weights."""
    import mxtpu.module as jmod
    from mxtpu_torch import module as tmod
    cpu = mxtpu_torch.cpu()
    j = _hook_graph(jsym, "Embedding")
    t = _hook_graph(tsym, "Embedding")
    jm = jmod.Module(j, data_names=("data",), label_names=None)
    tm = tmod.Module(t, data_names=("data",), label_names=None,
                     context=cpu)
    for m in (jm, tm):
        m.bind(data_shapes=[("data", (4, 8))], for_training=False)
        m.init_params()
    (jargs, _), (targs, _) = jm.get_params(), tm.get_params()
    assert {k: v.shape for k, v in targs.items()} == \
        {k: tuple(v.shape) for k, v in jargs.items()}
    msgs = []
    for mod, err, sym_mod in ((jmod, mxtpu.MXNetError, jsym),
                              (tmod, MXNetError, tsym)):
        kw = {} if mod is jmod else {"context": cpu}
        m = mod.Module(sym_mod.load(bert_export[0]), data_names=("data",),
                       label_names=None, **kw)
        with pytest.raises(err, match="could not infer") as e:
            m.bind(data_shapes=[("data", (4, 8))], for_training=False)
        msgs.append(str(e.value).split("—")[0])
    assert msgs[0] == msgs[1]
