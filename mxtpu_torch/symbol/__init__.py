"""``mxtpu_torch.symbol`` — the declarative graph API (the counterpart
of ``mxtpu/symbol/__init__.py``).

Reference: ``python/mxnet/symbol/symbol.py``† (Symbol compose /
``tojson`` / ``infer_shape`` / ``bind``) over the NNVM graph IR.

A Symbol is a DAG of op nodes that executes by interpretation through
the registry's torch rules, the same ones ``nd`` runs; the Executor
runs that interpretation eagerly.  Shape inference runs the rules on
``meta`` tensors.

JSON format: the nnvm-style node list (``op``/``name``/``attrs``/
``inputs`` + ``arg_nodes``/``heads``), written byte for byte as mxtpu
writes it, so ``-symbol.json`` files cross between the two packages.

One difference from mxtpu: an op with hidden outputs composes by its
first output, as in the reference (``NumVisibleOutputs``†).
``sym.Activation(sym.BatchNorm(x))`` takes BatchNorm's output 0 here,
where mxtpu raises and its own graphs index ``[0]``; the graph, and so
the JSON, is the same either way.
"""
from __future__ import annotations

import ast
import builtins
import json
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, _as_list
from ..ops.registry import OP_REGISTRY, get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "fromjson"]

_NAME_LOCK = threading.Lock()
_NAME_COUNTERS: Dict[str, int] = {}


def _auto_name(op_name: str) -> str:
    hint = op_name.lower().lstrip("_")
    with _NAME_LOCK:
        idx = _NAME_COUNTERS.get(hint, 0)
        _NAME_COUNTERS[hint] = idx + 1
    return f"{hint}{idx}"


class _Node:
    """One graph node: a variable (``op is None``) or an op application."""

    __slots__ = ("op", "name", "inputs", "attrs", "num_outputs")

    def __init__(self, op: Optional[str], name: str,
                 inputs: List[Tuple["_Node", int]],
                 attrs: Dict[str, Any], num_outputs: int = 1):
        self.op = op
        self.name = name
        self.inputs = inputs
        self.attrs = attrs
        self.num_outputs = num_outputs


def _coerce_attr(v: Any) -> Any:
    """JSON attrs are strings (reference format); coerce generically —
    typed coercion happens again in the op's ParamSet on invocation."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


class Symbol:
    """A set of output heads over the node DAG (exactly nnvm's model:
    a symbol IS its head list)."""

    __slots__ = ("_heads",)

    def __init__(self, heads: List[Tuple[_Node, int]]):
        self._heads = heads

    # -- identity -------------------------------------------------------
    @property
    def name(self) -> str:
        if len(self._heads) != 1:
            return "grouped_symbol"
        return self._heads[0][0].name

    def __repr__(self):
        return f"<Symbol {' '.join(n.name for n, _ in self._heads)}>"

    def __iter__(self):
        return iter(self[i] for i in range(len(self._heads)))

    def __len__(self):
        return len(self._heads)

    def __getitem__(self, index):
        if isinstance(index, str):
            internals = self.get_internals()
            names = internals.list_outputs()
            if index in names:
                return internals[names.index(index)]
            raise MXNetError(f"no internal output named {index!r}; "
                             f"try one of {names[:20]}…")
        # NB: the generated op namespace shadows builtins like ``slice``
        # and ``abs`` at module scope — always go through ``builtins``.
        if isinstance(index, builtins.slice):
            return Symbol(self._heads[index])
        return Symbol([self._heads[index]])

    # -- traversal ------------------------------------------------------
    def _topo(self) -> List[_Node]:
        # Iterative postorder DFS — graphs (unrolled RNNs, deep chains)
        # routinely exceed Python's recursion limit.
        seen: set = set()
        order: List[_Node] = []
        stack: List[Tuple[_Node, bool]] = [
            (node, False) for node, _ in reversed(self._heads)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for src, _ in reversed(node.inputs):
                if id(src) not in seen:
                    stack.append((src, False))
        return order

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo()
                if n.op is None and not _is_aux_name(n.name)]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo()
                if n.op is None and _is_aux_name(n.name)]

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._topo() if n.op is None]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, idx in self._heads:
            if node.num_outputs > 1:
                outs.append(f"{node.name}_output{idx}")
            elif node.op is None:
                outs.append(node.name)
            else:
                outs.append(f"{node.name}_output")
        return outs

    def get_internals(self) -> "Symbol":
        """Every node output as a head (reference ``get_internals``†)."""
        heads = []
        for node in self._topo():
            for i in range(node.num_outputs):
                heads.append((node, i))
        return Symbol(heads)

    def get_children(self) -> Optional["Symbol"]:
        heads = []
        for node, _ in self._heads:
            heads.extend(node.inputs)
        return Symbol(heads) if heads else None

    # -- attributes -----------------------------------------------------
    def attr(self, key: str) -> Optional[str]:
        if len(self._heads) == 1:
            v = self._heads[0][0].attrs.get(key)
            return None if v is None else str(v)
        return None

    def list_attr(self) -> Dict[str, str]:
        if len(self._heads) == 1:
            return {k: str(v) for k, v in self._heads[0][0].attrs.items()}
        return {}

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for node in self._topo():
            if node.attrs:
                out[node.name] = {k: str(v) for k, v in node.attrs.items()}
        return out

    # -- serialization --------------------------------------------------
    def tojson(self) -> str:
        order = self._topo()
        node_id = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry: Dict[str, Any] = {
                "op": "null" if n.op is None else n.op,
                "name": n.name,
                "inputs": [[node_id[id(s)], i, 0] for s, i in n.inputs],
            }
            if n.attrs:
                entry["attrs"] = {k: str(v) for k, v in n.attrs.items()
                                  if v is not None}
            nodes.append(entry)
        payload = {
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.op is None],
            "heads": [[node_id[id(n)], i, 0] for n, i in self._heads],
            "attrs": {"mxtpu_json": "1"},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- composition ----------------------------------------------------
    def _head1(self) -> Tuple[_Node, int]:
        if len(self._heads) == 1:
            return self._heads[0]
        node = self._heads[0][0]
        if node.op in _ONE_VISIBLE and not _coerce_attr(
                node.attrs.get("output_mean_var", False)) and \
                self._heads == [(node, i) for i in
                                range(node.num_outputs)]:
            return self._heads[0]
        raise MXNetError(
            "a multi-output symbol must be indexed before use as an "
            "op input (reference semantics)")

    # arithmetic (maps to the same registered ops NDArray uses)
    def __add__(self, other):
        return _binop(self, other, "broadcast_add", "_plus_scalar", False)

    __radd__ = __add__

    def __sub__(self, other):
        return _binop(self, other, "broadcast_sub", "_minus_scalar", False)

    def __rsub__(self, other):
        return _binop(self, other, "broadcast_sub", "_rminus_scalar", True)

    def __mul__(self, other):
        return _binop(self, other, "broadcast_mul", "_mul_scalar", False)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binop(self, other, "broadcast_div", "_div_scalar", False)

    def __rtruediv__(self, other):
        return _binop(self, other, "broadcast_div", "_rdiv_scalar", True)

    def __mod__(self, other):
        return _binop(self, other, "broadcast_mod", "_mod_scalar", False)

    def __rmod__(self, other):
        return _binop(self, other, "broadcast_mod", "_rmod_scalar", True)

    def __pow__(self, other):
        return _binop(self, other, "broadcast_power", "_power_scalar",
                      False)

    def __rpow__(self, other):
        return _binop(self, other, "broadcast_power", "_rpower_scalar",
                      True)

    def __neg__(self):
        return _create("negative", [self], {})

    def __abs__(self):
        return _create("abs", [self], {})

    def __eq__(self, other):  # noqa: A003 — reference returns a symbol
        if isinstance(other, (Symbol, int, float)):
            return _binop(self, other, "broadcast_equal", "_equal_scalar",
                          False)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return _binop(self, other, "broadcast_not_equal",
                          "_not_equal_scalar", False)
        return NotImplemented

    def __gt__(self, other):
        return _binop(self, other, "broadcast_greater", "_greater_scalar",
                      False)

    def __ge__(self, other):
        return _binop(self, other, "broadcast_greater_equal",
                      "_greater_equal_scalar", False)

    def __lt__(self, other):
        return _binop(self, other, "broadcast_lesser", "_lesser_scalar",
                      False)

    def __le__(self, other):
        return _binop(self, other, "broadcast_lesser_equal",
                      "_lesser_equal_scalar", False)

    def __hash__(self):
        return id(self)

    def __copy__(self):
        return Symbol(list(self._heads))

    def __deepcopy__(self, memo):
        return fromjson(self.tojson())

    # method-style ops the reference exposes on Symbol
    def reshape(self, shape):
        return _create("reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _create("transpose", [self],
                       {} if axes is None else {"axes": tuple(axes)})

    def sum(self, axis=None, keepdims=False):
        return _create("sum", [self],
                       {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _create("mean", [self],
                       {"axis": axis, "keepdims": keepdims})

    def astype(self, dtype):
        return _create("cast", [self], {"dtype": str(np.dtype(dtype))})

    # -- inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes, unknown = \
            self._infer_shape_impl(args, kwargs)
        if unknown:
            raise MXNetError(
                f"infer_shape: could not infer {sorted(unknown)} — "
                f"provide their shapes (partial inference covers the "
                f"common NN ops; see infer_shape_partial)")
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        arg_shapes, out_shapes, aux_shapes, _ = \
            self._infer_shape_impl(args, kwargs)
        return arg_shapes, out_shapes, aux_shapes

    def _infer_shape_impl(self, args, kwargs):
        arg_names = self.list_arguments()
        known: Dict[str, Tuple[int, ...]] = {}
        if args:
            if kwargs:
                raise MXNetError("pass shapes positionally or by name")
            for name, shape in zip(arg_names, args):
                if shape is not None:
                    known[name] = tuple(shape)
        else:
            known = {k: tuple(v) for k, v in kwargs.items()
                     if v is not None}

        shapes: Dict[Tuple[int, int], Optional[Tuple[int, ...]]] = {}
        unknown: set = set()
        var_nodes: Dict[str, _Node] = {}
        for node in self._topo():
            if node.op is None:
                var_nodes.setdefault(node.name, node)
                shp = known.get(node.name)
                if shp is None and node.attrs.get("__shape__") is not None:
                    shp = tuple(_coerce_attr(node.attrs["__shape__"]))
                shapes[(id(node), 0)] = shp
                if shp is None:
                    unknown.add(node.name)
                continue
            in_shapes = [shapes.get((id(s), i)) for s, i in node.inputs]
            if any(s is None for s in in_shapes):
                hook = _INFER_HOOKS.get(node.op)
                if hook is not None:
                    hinted = hook(in_shapes, node.attrs)
                    for (src, i), hs in zip(node.inputs, hinted):
                        if hs is not None and shapes.get((id(src), i)) \
                                is None:
                            shapes[(id(src), i)] = tuple(hs)
                            if src.op is None:
                                unknown.discard(src.name)
                    in_shapes = [shapes.get((id(s), i))
                                 for s, i in node.inputs]
            if any(s is None for s in in_shapes):
                for i in range(node.num_outputs):
                    shapes[(id(node), i)] = None
                continue
            outs = _abstract_eval(node, in_shapes)
            for i, o in enumerate(outs):
                shapes[(id(node), i)] = o

        def _var_head(n):
            node = var_nodes.get(n)
            return (id(node), 0) if node is not None else None

        arg_shapes = [shapes.get(_var_head(n)) for n in arg_names]
        aux_shapes = [shapes.get(_var_head(n))
                      for n in self.list_auxiliary_states()]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._heads]
        # re-scan unknown: hooks may have filled vars
        still_unknown = {n for n, s in zip(arg_names, arg_shapes)
                         if s is None} | \
                        {n for n, s in zip(self.list_auxiliary_states(),
                                           aux_shapes) if s is None}
        return arg_shapes, out_shapes, aux_shapes, still_unknown

    def infer_type(self, *args, **kwargs):
        """Everything defaults to float32 unless a var carries
        ``__dtype__`` (the eager path is the dtype oracle; symbols track
        shapes), as in mxtpu."""
        var_nodes = {n.name: n for n in self._topo() if n.op is None}
        arg_types = []
        for n in self.list_arguments():
            node = var_nodes.get(n)
            dt = node.attrs.get("__dtype__") if node is not None else None
            arg_types.append(np.dtype(dt) if dt else np.dtype("float32"))
        out_types = [np.dtype("float32")] * len(self._heads)
        aux_types = [np.dtype("float32")] * \
            len(self.list_auxiliary_states())
        return arg_types, out_types, aux_types

    # -- execution ------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """Evaluate eagerly with named NDArray bindings."""
        return _eval_symbol(self, kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        """An :class:`~mxtpu_torch.executor.Executor` over ``args`` on
        ``ctx`` (default the card)."""
        from ..executor import Executor
        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    def simple_bind(self, ctx=None, grad_req="write", **shape_kwargs):
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    **shape_kwargs)

    # reference: symbol composition sym2(data=sym1)
    def __call__(self, *args, **kwargs):
        mapping: Dict[str, Symbol] = {}
        arg_names = self.list_arguments()
        for name, s in zip(arg_names, args):
            mapping[name] = s
        mapping.update(kwargs)
        for k, v in mapping.items():
            if not isinstance(v, Symbol):
                raise MXNetError("composition args must be Symbols")
        return _compose(self, mapping)


def _is_aux_name(name: str) -> bool:
    """Reference convention: BatchNorm moving stats are auxiliary
    states, identified by name (``moving_mean``/``moving_var`` upstream;
    gluon uses ``running_``)."""
    return name.endswith(("moving_mean", "moving_var", "running_mean",
                          "running_var"))


def _abstract_eval(node: _Node, in_shapes) -> List[Tuple[int, ...]]:
    """Shape inference by running the op's rule on ``meta`` tensors —
    the role of the reference's ``InferShape`` pass
    (``src/executor/infer_graph_attr_pass.cc``†)."""
    return _op_of(node).infer(*in_shapes, **_node_attrs(node))


def _op_of(node: _Node):
    try:
        return get_op(node.op)
    except MXNetError:
        raise MXNetError(f"unknown op {node.op!r} in symbol graph") \
            from None


def _node_attrs(node: _Node) -> Dict[str, Any]:
    return {k: _coerce_attr(v) for k, v in node.attrs.items()
            if not k.startswith("__")}


# ops whose extra outputs are hidden: a symbol of all their outputs
# composes as output 0 (the reference's NumVisibleOutputs)
_ONE_VISIBLE = ("BatchNorm", "batch_norm", "BatchNorm_v1")


# param-shape hints for ops whose weight shapes the reference infers
# backward from the data shape (what lets Module.bind work from
# data_shapes alone)
def _fc_hook(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return [None] * len(in_shapes)
    nh = int(_coerce_attr(attrs.get("num_hidden", 0)))
    flatten = bool(_coerce_attr(attrs.get("flatten", True)))
    in_units = int(np.prod(data[1:])) if flatten or len(data) == 2 \
        else data[-1]
    out = [data, (nh, in_units)]
    if len(in_shapes) > 2:
        out.append((nh,))
    return out


def _conv_hook(in_shapes, attrs):
    data = in_shapes[0]
    if data is None:
        return [None] * len(in_shapes)
    kernel = tuple(_coerce_attr(attrs.get("kernel", ())))
    nf = int(_coerce_attr(attrs.get("num_filter", 0)))
    ng = int(_coerce_attr(attrs.get("num_group", 1)))
    c = data[1]  # NC... layouts (default); NHWC nets pass explicit shapes
    out = [data, (nf, c // ng) + kernel]
    if len(in_shapes) > 2:
        out.append((nf,))
    return out


def _channel_hook(in_shapes, attrs, default_axis=1):
    # gamma, beta and the moving statistics are (C,) of the data's
    # normalised axis; default_axis is the op's Param default:
    # BatchNorm and InstanceNorm per channel (1), LayerNorm per the
    # last axis (-1)
    data = in_shapes[0]
    if data is None:
        return [None] * len(in_shapes)
    axis = int(_coerce_attr(attrs.get("axis", default_axis)))
    c = data[axis]
    return [data] + [(c,)] * (len(in_shapes) - 1)


def _embedding_hook(in_shapes, attrs):
    data = in_shapes[0]
    ind = int(_coerce_attr(attrs.get("input_dim", 0)))
    outd = int(_coerce_attr(attrs.get("output_dim", 0)))
    return [data, (ind, outd)]


def _deconv_hook(in_shapes, attrs):
    """mxtpu's ``_deconv_hook``: weights (in, num_filter/g, *kernel)
    from the data's axis 1."""
    data = in_shapes[0]
    if data is None:
        return [None] * len(in_shapes)
    kernel = tuple(_coerce_attr(attrs.get("kernel", ())))
    nf = int(_coerce_attr(attrs.get("num_filter", 0)))
    ng = int(_coerce_attr(attrs.get("num_group", 1)))
    out = [data, (data[1], nf // ng) + kernel]
    if len(in_shapes) > 2:
        out.append((nf,))
    return out


_INFER_HOOKS = {
    "FullyConnected": _fc_hook,
    "Convolution": _conv_hook,
    "Deconvolution": _deconv_hook,
    "BatchNorm": _channel_hook,
    "BatchNormRelu": _channel_hook,
    # addend (input 1) is data-shaped, the rest are (C,)
    "BatchNormAddRelu": lambda in_shapes, attrs: (
        lambda full: [full[0], full[0]] + full[1:]
    )(_channel_hook([in_shapes[0]] + list(in_shapes[2:]), attrs)),
    "InstanceNorm": _channel_hook,
    "LayerNorm": lambda in_shapes, attrs: _channel_hook(
        in_shapes, attrs, default_axis=-1),
    "Embedding": _embedding_hook,
}


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------
def var(name: str, attr=None, shape=None, dtype=None, init=None,
        lr_mult=None, wd_mult=None, **kwargs) -> Symbol:
    """Create a variable (reference ``mx.sym.var``/``Variable``†)."""
    if not isinstance(name, str):
        raise MXNetError("variable name must be a string")
    attrs: Dict[str, Any] = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(np.dtype(dtype))
    if init is not None:
        attrs["__init__"] = str(init)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, [], attrs), 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:  # noqa: N802
    """Multi-head symbol (reference ``mx.sym.Group``†)."""
    heads: List[Tuple[_Node, int]] = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def _num_outputs_of(op_name: str, n_inputs: int, attrs) -> int:
    try:
        op = get_op(op_name)
    except MXNetError:
        return 1
    if op.num_outputs_fn is not None:
        # apply Param defaults first so num_outputs_fn callbacks see
        # resolved attrs, not raw ones — otherwise every callback must
        # individually defend against missing keys (r4 review)
        attrs_c = {k: _coerce_attr(v) for k, v in attrs.items()}
        try:
            attrs_c = op.resolve_params(
                {k: v for k, v in attrs_c.items()
                 if k in op.params.params})
        except MXNetError:
            pass  # bad attr values surface at execution time instead
        return op.num_outputs_fn(attrs_c)
    if op.num_outputs == -1:
        if op_name in ("split", "SliceChannel"):
            return int(_coerce_attr(attrs.get("num_outputs", 1)))
        return 1
    return op.num_outputs


def _create(op_name: str, inputs: Sequence[Any], attrs: Dict[str, Any],
            name: Optional[str] = None) -> Symbol:
    heads: List[Tuple[_Node, int]] = []
    for x in inputs:
        if isinstance(x, Symbol):
            heads.append(x._head1())
        else:
            raise MXNetError(
                f"symbol op {op_name} inputs must be Symbols, got "
                f"{type(x).__name__}")
    clean = {k: v for k, v in attrs.items() if v is not None}
    node = _Node(op_name, name or _auto_name(op_name), heads, clean,
                 _num_outputs_of(op_name, len(heads), clean))
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _binop(lhs: Symbol, rhs, tensor_op: str, scalar_op: str,
           reflected: bool) -> Symbol:
    if isinstance(rhs, Symbol):
        return _create(tensor_op, [rhs, lhs] if reflected else [lhs, rhs],
                       {})
    return _create(scalar_op, [lhs], {"scalar": float(rhs)})


def _compose(sym: Symbol, mapping: Dict[str, Symbol]) -> Symbol:
    """Graft symbols onto named variables (reference composition)."""
    # memo stores the FULL replacement (node, head_idx) so a variable
    # referenced more than once keeps binding to the mapped head's
    # output index (ridx == -1 means "keep the caller's index").
    memo: Dict[int, Tuple[_Node, int]] = {}

    def rebuild(node: _Node) -> Tuple[_Node, int]:
        if id(node) in memo:
            return memo[id(node)]
        if node.op is None and node.name in mapping:
            result = mapping[node.name]._head1()
            memo[id(node)] = result
            return result
        new_inputs = []
        for src, i in node.inputs:
            rep, ridx = rebuild(src)
            new_inputs.append((rep, i if ridx == -1 else ridx))
        if len(new_inputs) == len(node.inputs) and all(
                a is b and i == j for (a, i), (b, j)
                in zip(new_inputs, node.inputs)):
            memo[id(node)] = (node, -1)
            return node, -1
        new = _Node(node.op, node.name, new_inputs, dict(node.attrs),
                    node.num_outputs)
        memo[id(node)] = (new, -1)
        return new, -1

    heads = []
    for node, idx in sym._heads:
        rep, ridx = rebuild(node)
        heads.append((rep, idx if ridx == -1 else ridx))
    return Symbol(heads)


# ops whose key input a graph omits (drawn at evaluation time)
_KEY_OPS = ("Dropout", "FusedResidualLayerNorm")


# ----------------------------------------------------------------------
# evaluation (the executor's engine — interpretation over nd ops)
# ----------------------------------------------------------------------
_NO_INPUTS, _KEY_DRAWN, _PLAIN = range(3)


class _GraphPlan:
    """A graph's interpretation resolved once: the topological order,
    each op node's coerced attributes, its op and resolved params, how
    it is called (an op with no inputs creates on the bindings' device;
    a ``_KEY_OPS`` node whose graph omits the key goes through the nd
    convenience that draws it), a slot index for every node output in
    place of a dict keyed by node identity, and for each step the
    outputs it drops because no later step reads them.

    Nothing in it depends on the bindings: :meth:`run` takes them on
    every call and computes what :func:`_eval_symbol` always did, op
    call for op call.  A runner builds one per graph and runs it for
    every bucket."""

    __slots__ = ("_vars", "_steps", "_heads", "_n_slots")

    def __init__(self, sym: Symbol):
        from .. import ndarray as nd_mod
        order = sym._topo()
        # slots a node's outputs need: what its op declares, or more
        # where a consumer or a head reads further
        width = {id(n): builtins.max(1, n.num_outputs) for n in order}
        for n in order:
            for s, i in n.inputs:
                width[id(s)] = builtins.max(width[id(s)], i + 1)
        for n, i in sym._heads:
            width[id(n)] = builtins.max(width[id(n)], i + 1)
        base: Dict[int, int] = {}
        self._vars: List[Tuple[str, int]] = []
        self._steps: List[Tuple] = []
        n_slots = 0
        for node in order:
            base[id(node)] = n_slots
            outs = tuple(range(n_slots, n_slots + width[id(node)]))
            n_slots += len(outs)
            if node.op is None:
                self._vars.append((node.name, outs[0]))
                continue
            ins = tuple(base[id(s)] + i for s, i in node.inputs)
            op = _op_of(node)
            attrs = _node_attrs(node)
            if op.num_inputs == 0:
                step = (_NO_INPUTS, op, op.resolve_params(attrs))
            elif op.name in _KEY_OPS and len(ins) < op.num_inputs:
                # the graph omits the key input: the nd convenience
                # draws it (and reads the training mode) at each run
                step = (_KEY_DRAWN, getattr(nd_mod, op.name), attrs)
            else:
                step = (_PLAIN, op, op.resolve_params(attrs))
            self._steps.append(step + (ins, outs, node.op,
                                       f"{node.name!r} ({node.op})"))
        self._heads = [base[id(n)] + i for n, i in sym._heads]
        self._n_slots = n_slots
        # each step drops the op outputs no later step reads, so a run
        # holds only live intermediates (a captured graph's pool too)
        last: Dict[int, int] = {}
        for k, step in enumerate(self._steps):
            for i in step[3]:
                last[i] = k
        keep = set(self._heads) | {slot for _, slot in self._vars}
        drops: List[List[int]] = [[] for _ in self._steps]
        for k, step in enumerate(self._steps):
            for i in step[4]:
                if i not in keep:
                    drops[last.get(i, k)].append(i)
        self._steps = [step + (tuple(d),)
                       for step, d in zip(self._steps, drops)]

    def run(self, bindings: Dict[str, Any]) -> List[Any]:
        """The graph on ``bindings`` (var name -> NDArray or array);
        a list of NDArray, one per head."""
        from .. import ndarray as nd_mod
        from ..ndarray.ndarray import NDArray
        vals: List[Any] = [None] * self._n_slots
        for name, slot in self._vars:
            if name not in bindings:
                raise MXNetError(f"unbound variable {name!r}")
            val = bindings[name]
            vals[slot] = val if isinstance(val, NDArray) \
                else nd_mod.array(val)
        # an op with no inputs (_arange) creates on the bindings' device
        ctx = next((v._data.device for v in bindings.values()
                    if isinstance(v, NDArray)), None)
        invoke = nd_mod._invoke_resolved
        where = None
        try:
            for kind, fn, params, ins, outs, name, where, drops in \
                    self._steps:
                args = [vals[i] for i in ins]
                if kind == _PLAIN:
                    out = invoke(fn, params, args, None, name)
                elif kind == _KEY_DRAWN:
                    out = fn(*args, **params)
                else:
                    out = invoke(fn, params, (), ctx)
                if isinstance(out, (list, tuple)):
                    for slot, o in zip(outs, out):
                        vals[slot] = o
                else:
                    vals[outs[0]] = out
                for i in drops:
                    vals[i] = None
        except Exception as e:
            # which node failed (what a failed CUDA graph capture names)
            e.add_note(f"graph node {where}")
            raise
        return [vals[i] for i in self._heads]


def _eval_symbol(outputs, bindings: Dict[str, Any]):
    """Topologically interpret a symbol through the eager op namespace.
    ``bindings`` maps var name → NDArray.  Returns a list of NDArray
    (single-head symbols still return a 1-list, reference executor
    semantics).  A caller that runs one graph many times builds its
    :class:`_GraphPlan` once instead."""
    sym = outputs if isinstance(outputs, Symbol) else Group(
        _as_list(outputs))
    return _GraphPlan(sym).run(bindings)


# ----------------------------------------------------------------------
# deserialization
# ----------------------------------------------------------------------
def fromjson(json_str: str) -> Symbol:
    payload = json.loads(json_str)
    raw_nodes = payload["nodes"]
    nodes: List[_Node] = []
    for rn in raw_nodes:
        op = rn["op"]
        attrs = dict(rn.get("attrs", rn.get("param", {})) or {})
        node = _Node(None if op == "null" else op, rn["name"], [], attrs)
        nodes.append(node)
    for node, rn in zip(nodes, raw_nodes):
        node.inputs = [(nodes[i], idx) for i, idx, *_ in rn["inputs"]]
        if node.op is not None:
            node.num_outputs = _num_outputs_of(
                node.op, len(node.inputs), node.attrs)
    heads = payload.get("heads")
    if heads:
        return Symbol([(nodes[i], idx) for i, idx, *_ in heads])
    return Symbol([(nodes[-1], 0)])


load_json = fromjson


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return fromjson(f.read())


# ----------------------------------------------------------------------
# generated op namespace (mirrors nd)
# ----------------------------------------------------------------------
_THIS = sys.modules[__name__]

# Reference behavior: NN ops auto-create their weight variables when not
# passed explicitly (``sym.FullyConnected(data, num_hidden=8, name='fc1')``
# creates ``fc1_weight``/``fc1_bias``) — what makes pure-symbolic model
# definitions (Module examples†) concise.  Slot names follow upstream.
_AUTO_VARS: Dict[str, List[str]] = {
    "FullyConnected": ["data", "weight", "bias"],
    "Convolution": ["data", "weight", "bias"],
    "Deconvolution": ["data", "weight", "bias"],
    "BatchNorm": ["data", "gamma", "beta", "moving_mean", "moving_var"],
    "BatchNormRelu": ["data", "gamma", "beta", "moving_mean",
                      "moving_var"],
    "BatchNormAddRelu": ["data", "addend", "gamma", "beta",
                         "moving_mean", "moving_var"],
    "LayerNorm": ["data", "gamma", "beta"],
    "InstanceNorm": ["data", "gamma", "beta"],
    "Embedding": ["data", "weight"],
    "SoftmaxOutput": ["data", "label"],
}


def _make_sym_fn(op_name: str):
    slots = _AUTO_VARS.get(op_name)

    def fn(*args, name: Optional[str] = None, **kwargs):
        syms = []
        for a in args:
            if isinstance(a, Symbol):
                syms.append(a)
            elif isinstance(a, (list, tuple)) and all(
                    isinstance(x, Symbol) for x in a):
                syms.extend(a)
            else:
                raise MXNetError(
                    f"sym.{op_name} takes Symbol inputs, got "
                    f"{type(a).__name__} (use nd for eager arrays)")
        if slots is not None:
            # Fill remaining slots IN ORDER: a keyword symbol binds to its
            # named slot; any earlier unfilled slot gets an auto-var (so
            # e.g. FullyConnected(data, bias=b) still auto-creates weight).
            node_name = name or _auto_name(op_name)
            n_expected = len(slots)
            if kwargs.get("no_bias") and "bias" in slots:
                n_expected -= 1
            for slot in slots[len(syms):n_expected]:
                if slot in kwargs and isinstance(kwargs[slot], Symbol):
                    syms.append(kwargs.pop(slot))
                elif slot == "label":
                    syms.append(var(f"{node_name}_label"))
                else:
                    syms.append(var(f"{node_name}_{slot}"))
            return _create(op_name, syms, kwargs, name=node_name)
        return _create(op_name, syms, kwargs, name=name)
    fn.__name__ = op_name
    fn.__qualname__ = op_name
    return fn


_seen = set()
for _op in list(OP_REGISTRY._entries.values()):
    for _n in (_op.name,) + _op.aliases:
        if _n not in _seen:
            _seen.add(_n)
            setattr(_THIS, _n, _make_sym_fn(_n))
