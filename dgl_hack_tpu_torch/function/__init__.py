"""Builtin message/reduce function namespace — the user-facing algebra.

Mirrors ``dgl.function`` (reference: python/dgl/function/{base,message,
reducer}.py): message fns ``copy_u``/``copy_e`` and the generated
``{u,v,e}_{add,sub,mul,div,dot}_{u,v,e}`` family (reference:
function/message.py:169,209), reducers ``sum/max/min/prod/mean``
(reference: function/reducer.py:56,88).  These are lightweight descriptors;
``core.message`` lowers a (message, reduce) pair onto one gspmm call and a
message alone onto one gsddmm call (reference: the scheduler's fused v2v
path, python/dgl/runtime/scheduler.py:801,906 -> runtime/spmv.py:15).
A copy of ``dgl_hack_tpu.function``, which imports no JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["BuiltinMessage", "BuiltinReduce", "copy_u", "copy_e",
           "copy_src", "copy_edge", "sum", "max", "min", "prod", "mean"]

_BINARY_OPS = ("add", "sub", "mul", "div", "dot")
_TARGETS = ("u", "v", "e")


@dataclass(frozen=True)
class BuiltinMessage:
    """op(lhs_field@lhs_target, rhs_field@rhs_target) -> out_field."""
    op: str
    lhs_target: Optional[str]
    rhs_target: Optional[str]
    lhs_field: Optional[str]
    rhs_field: Optional[str]
    out_field: str

    @property
    def name(self) -> str:
        if self.op == "copy_lhs":
            return f"copy_{self.lhs_target}"
        return f"{self.lhs_target}_{self.op}_{self.rhs_target}"


@dataclass(frozen=True)
class BuiltinReduce:
    reducer: str          # sum | max | min | prod | mean
    msg_field: str
    out_field: str


def copy_u(u: str, out: str) -> BuiltinMessage:
    return BuiltinMessage("copy_lhs", "u", None, u, None, out)


def copy_e(e: str, out: str) -> BuiltinMessage:
    return BuiltinMessage("copy_lhs", "e", None, e, None, out)


# DGL-0.4 aliases (reference: function/message.py copy_src/copy_edge)
def copy_src(src: str, out: str) -> BuiltinMessage:
    return copy_u(src, out)


def copy_edge(edge: str, out: str) -> BuiltinMessage:
    return copy_e(edge, out)


def _make_binary(lhs_t: str, op: str, rhs_t: str):
    def fn(lhs_field: str, rhs_field: str, out: str) -> BuiltinMessage:
        return BuiltinMessage(op, lhs_t, rhs_t, lhs_field, rhs_field, out)
    fn.__name__ = f"{lhs_t}_{op}_{rhs_t}"
    fn.__doc__ = (f"Builtin message: out[e=(u,v)] = "
                  f"{lhs_t}[{ '{lhs}' }] {op} {rhs_t}[{ '{rhs}' }]")
    return fn


for _lhs in _TARGETS:
    for _op in _BINARY_OPS:
        for _rhs in _TARGETS:
            if _lhs == _rhs:
                continue
            _f = _make_binary(_lhs, _op, _rhs)
            globals()[_f.__name__] = _f
            __all__.append(_f.__name__)
# legacy names: src_mul_edge etc. (reference keeps both spellings)
globals()["src_mul_edge"] = globals()["u_mul_e"]
globals()["src_mul_dst"] = globals()["u_mul_v"]
__all__ += ["src_mul_edge", "src_mul_dst"]


def _make_reducer(name: str):
    def fn(msg: str, out: str) -> BuiltinReduce:
        return BuiltinReduce(name, msg, out)
    fn.__name__ = name
    fn.__doc__ = f"Builtin reducer: {name} over incoming messages."
    return fn


sum = _make_reducer("sum")      # noqa: A001 - DGL API parity
max = _make_reducer("max")      # noqa: A001
min = _make_reducer("min")      # noqa: A001
prod = _make_reducer("prod")
mean = _make_reducer("mean")
