"""Executor — a symbol bound to arrays (the counterpart of
``mxtpu/executor.py``).

Execution is eager: ``forward`` interprets the graph node by node
through the registry's torch rules, on the tensors of the bound arrays,
from a plan made once at bind time (each node's op and resolved
params).  In training mode it runs with torch's grad mode on, from
leaves that stand for the arguments whose ``grad_req`` is not
``"null"``; ``backward`` is ``torch.autograd.grad`` of the outputs
(with the given cotangents, or ones) into those leaves, stored by
``grad_req``.  The JAX package compiles the same interpretation under
``jax.jit`` (``executor.py:154-268``); the port has no compiled path
yet (CUDA graphs are later work), and so no fallback from one.

A monitor callback (``set_monitor_callback``, what ``Monitor.install``
sets) is handed each output by name after every ``forward``.

As in the JAX package, ``forward`` never writes the auxiliary states:
``BatchNorm`` returns its batch statistics and leaves ``moving_mean``
and ``moving_var`` as bound.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .base import MXNetError, _as_list
from .context import resolve_device
from .ndarray import ndarray as _nda
from .ndarray.ndarray import NDArray
from .symbol import Symbol, _is_aux_name, _node_attrs, _op_of

__all__ = ["Executor"]


class Executor:
    """A symbol bound to argument arrays (reference ``Executor``†).
    Arrays are placed on ``ctx`` (default the card)."""

    def __init__(self, symbol: Symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = resolve_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self._arg_names, self._aux_names = arg_names, aux_names

        self.arg_dict = self._name_arrays(args, arg_names, "args")
        self.aux_dict = self._name_arrays(aux_states, aux_names,
                                          "aux_states")
        missing = [n for n in arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(
                f"bind: unbound argument(s) {missing}; pass arrays for "
                f"every name in list_arguments() = {arg_names}")

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in arg_names}
        for n, req in self._grad_req.items():
            if req not in ("write", "add", "null"):
                raise MXNetError(f"invalid grad_req {req!r} for {n}")

        if args_grad is None:
            args_grad = {n: _nda.zeros(self.arg_dict[n].shape, self._ctx,
                                       self.arg_dict[n]._data.dtype)
                         for n in arg_names
                         if self._grad_req.get(n, "null") != "null"}
        self.grad_dict = self._name_arrays(args_grad, arg_names,
                                           "args_grad", allow_missing=True)

        # the plan: (op rule, resolved params, input keys, node id,
        # output count) per op node, in topological order
        self._plan = []
        for node in symbol._topo():
            if node.op is None:
                continue
            op = _op_of(node)
            self._plan.append((op.fn, op.resolve_params(_node_attrs(node)),
                               [(id(s), i) for s, i in node.inputs],
                               id(node)))
        self._vars = {n.name: id(n) for n in symbol._topo() if n.op is None}
        self._heads = [(id(n), i) for n, i in symbol._heads]

        self._outputs: Optional[List[NDArray]] = None
        self._monitor_callback = None
        self._graph_outs: Optional[List[torch.Tensor]] = None
        self._leaves: Dict[str, torch.Tensor] = {}

    def _name_arrays(self, arrays, names, what, allow_missing=False):
        if arrays is None:
            return {}
        if isinstance(arrays, dict):
            out = dict(arrays)
        else:
            arrays = _as_list(arrays)
            if len(arrays) != len(names) and not allow_missing:
                raise MXNetError(
                    f"{what}: expected {len(names)} arrays "
                    f"({names}), got {len(arrays)}")
            out = dict(zip(names, arrays))
        return {k: self._place(v) for k, v in out.items() if v is not None}

    def _place(self, v) -> NDArray:
        if isinstance(v, NDArray):
            return v.as_in_context(self._ctx)
        return _nda.array(v, ctx=self._ctx)

    # -- reference surface -------------------------------------------------
    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs is None:
            raise MXNetError("run forward() first")
        return self._outputs

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self._aux_names]

    def set_monitor_callback(self, callback, monitor_all=False) -> None:
        """``callback(name, NDArray)`` for each output after a forward."""
        self._monitor_callback = callback

    # -- execution ---------------------------------------------------------
    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; ``kwargs`` rebind arguments (or aux states) by
        name first.  In training mode the outputs keep a graph for
        :meth:`backward`."""
        for name, val in kwargs.items():
            val = self._place(val)
            if name in self.arg_dict:
                self.arg_dict[name] = val
            elif name in self.aux_dict or _is_aux_name(name):
                self.aux_dict[name] = val
            else:
                raise MXNetError(f"unknown argument {name!r}")
        values = {}
        self._leaves = {}
        for name, arr in self.aux_dict.items():
            values[(self._vars[name], 0)] = arr._data.detach()
        for name, arr in self.arg_dict.items():
            t = arr._data.detach()
            if is_train and self._grad_req.get(name, "null") != "null":
                t = t.requires_grad_(True)
                self._leaves[name] = t
            values[(self._vars[name], 0)] = t
        with torch.set_grad_enabled(bool(self._leaves)):
            for fn, params, ins, nid in self._plan:
                out = fn(*[values[k] for k in ins], **params)
                if isinstance(out, tuple):
                    for i, o in enumerate(out):
                        values[(nid, i)] = o
                else:
                    values[(nid, 0)] = out
        outs = [values[k] for k in self._heads]
        self._graph_outs = outs if self._leaves else None
        self._outputs = [NDArray(o.detach()) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self._symbol.list_outputs(),
                                 self._outputs):
                self._monitor_callback(name, out)
        return self._outputs

    def backward(self, out_grads=None) -> None:
        """Gradients of the last training forward's outputs, with the
        cotangents ``out_grads`` (default ones), into ``grad_dict`` by
        each argument's ``grad_req``."""
        if self._outputs is None:
            raise MXNetError("forward(is_train=True) before backward()")
        if self._graph_outs is None:
            raise MXNetError("backward() needs a forward(is_train=True) "
                             "with at least one argument whose grad_req "
                             "is not 'null'")
        outs = self._graph_outs
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            cots = [(g._data if isinstance(g, NDArray) else
                     torch.as_tensor(g, device=o.device)).to(o.dtype)
                    for g, o in zip(_as_list(out_grads), outs)]
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        names = list(self._leaves)
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [self._leaves[n] for n in names],
                [c for _, c in pairs], allow_unused=True)
        self._graph_outs = None
        for name, g in zip(names, grads):
            if g is None:
                g = torch.zeros_like(self._leaves[name])
            self._store_grad(name, g)

    def _store_grad(self, name: str, grad: torch.Tensor) -> None:
        req = self._grad_req.get(name, "write")
        dst = self.grad_dict.get(name)
        if dst is None:
            self.grad_dict[name] = NDArray(grad)
        elif req == "add":
            dst._data = dst._data + grad
        else:
            dst._data = grad

    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False) -> None:
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name] = self._place(arr).copy()
            elif not allow_extra_params:
                raise MXNetError(f"unknown parameter {name!r}")
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name] = self._place(arr).copy()
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {name!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs) -> "Executor":
        """Rebind with new input shapes: a fresh Executor sharing the
        other arrays."""
        new_args = {n: (_nda.zeros(kwargs[n], self._ctx) if n in kwargs
                        else arr) for n, arr in self.arg_dict.items()}
        return Executor(self._symbol, self._ctx, args=new_args,
                        grad_req=self._grad_req,
                        aux_states=dict(self.aux_dict))

    @staticmethod
    def simple_bind(symbol: Symbol, ctx=None, grad_req="write",
                    type_dict=None, **shape_kwargs) -> "Executor":
        """Infer every shape from the given input shapes and allocate
        zeros (reference ``simple_bind``†)."""
        dev = resolve_device(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        type_dict = type_dict or {}
        args = {n: _nda.zeros(s, dev, type_dict.get(n, "float32"))
                for n, s in zip(symbol.list_arguments(), arg_shapes)}
        aux = {n: _nda.zeros(s, dev)
               for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
        return Executor(symbol, dev, args=args, grad_req=grad_req,
                        aux_states=aux)
