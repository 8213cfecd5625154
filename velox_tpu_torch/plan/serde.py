"""Plan <-> JSON serialization (the port of the JAX package's
``plan/serde.py``, its wire format).

Analog of velox's ISerializable plan serde (velox/core/PlanNode.h
PlanNode::serialize / PlanNode::create), used to ship a fragment's plan
and by trace replay. Nodes, types and typed expressions round-trip
structurally (no string re-parsing, so resolved types and bound literals
survive). A ValuesNode's batches travel as ``serial/page.py`` pages in
base64, the exchange's wire format.

A plan either package writes, the other reads. The one field the JAX
package lacks is ``Literal.text`` (the numeral of a DOUBLE literal as
written, which a long-decimal compare reads its digits from): it goes on
the wire as a ``"text"`` key beside ``"value"`` when set, which the JAX
package's reader ignores; a literal read from a plan without it has no
text, so such a compare then reads the float, as the JAX package does.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
from typing import Any, Dict

from velox_tpu_torch.types.types import (
    ArrayType, DataType, DecimalType, MapType, RowType, TypeKind,
)
from velox_tpu_torch.expr import ir as E
from velox_tpu_torch.plan import nodes as N

# ------------------------------------------------------------------ types


def type_to_dict(t: DataType) -> dict:
    if isinstance(t, RowType):
        return {"kind": "ROW", "names": list(t.names),
                "children": [type_to_dict(c) for c in t.children]}
    if isinstance(t, ArrayType):
        return {"kind": "ARRAY", "element": type_to_dict(t.element)}
    if isinstance(t, MapType):
        return {"kind": "MAP", "key": type_to_dict(t.key),
                "value": type_to_dict(t.value)}
    if isinstance(t, DecimalType):
        return {"kind": "DECIMAL", "precision": t.precision,
                "scale": t.scale}
    return {"kind": t.kind.name}


def type_from_dict(d: dict) -> DataType:
    kind = d["kind"]
    if kind == "ROW":
        return RowType(TypeKind.ROW, tuple(d["names"]),
                       tuple(type_from_dict(c) for c in d["children"]))
    if kind == "ARRAY":
        return ArrayType(TypeKind.ARRAY, type_from_dict(d["element"]))
    if kind == "MAP":
        return MapType(TypeKind.MAP, type_from_dict(d["key"]),
                       type_from_dict(d["value"]))
    if kind == "DECIMAL":
        return DecimalType(TypeKind.DECIMAL, d["precision"], d["scale"])
    return DataType(TypeKind[kind])


def _opt_type(t):
    return None if t is None else type_to_dict(t)


def _opt_type_from(d):
    return None if d is None else type_from_dict(d)


# ------------------------------------------------------- typed expressions


def expr_to_dict(e: E.Expr) -> dict:
    t = _opt_type(e.dtype)
    if isinstance(e, E.FieldRef):
        return {"k": "field", "t": t, "name": e.name}
    if isinstance(e, E.Literal):
        v = e.value
        if hasattr(v, "item"):           # numpy scalar
            v = v.item()
        if not isinstance(v, (int, float, str, bool, type(None))):
            raise TypeError(f"unserializable literal {type(v).__name__}")
        d = {"k": "lit", "t": t, "value": v}
        if e.text is not None:
            d["text"] = e.text
        return d
    if isinstance(e, E.Cast):
        return {"k": "cast", "t": t, "expr": expr_to_dict(e.expr),
                "try": e.null_on_failure}
    if isinstance(e, E.TryExpr):
        return {"k": "try", "t": t, "expr": expr_to_dict(e.expr)}
    if isinstance(e, E.Call):
        return {"k": "call", "t": t, "name": e.name,
                "args": [expr_to_dict(a) for a in e.args]}
    raise TypeError(f"unserializable expr {type(e).__name__}")


def expr_from_dict(d: dict) -> E.Expr:
    t = _opt_type_from(d["t"])
    k = d["k"]
    if k == "field":
        return E.FieldRef(t, d["name"])
    if k == "lit":
        return E.Literal(t, d["value"], d.get("text"))
    if k == "cast":
        return E.Cast(t, expr_from_dict(d["expr"]), d["try"])
    if k == "try":
        return E.TryExpr(t, expr_from_dict(d["expr"]))
    if k == "call":
        return E.Call(t, d["name"],
                      tuple(expr_from_dict(a) for a in d["args"]))
    raise TypeError(f"bad expr tag {k!r}")


# ------------------------------------------------------------- plan nodes

_NODE_TYPES: Dict[str, type] = {
    cls.__name__: cls for cls in vars(N).values()
    if isinstance(cls, type) and issubclass(cls, N.PlanNode)
}


def register_node_type(cls: type) -> None:
    """Extension hook (``PartitionedOutputNode`` registers here)."""
    _NODE_TYPES[cls.__name__] = cls


_SPEC_TYPES: Dict[str, type] = {
    c.__name__: c for c in (N.AggregateSpec, N.SortField, N.WindowSpec)}


def _value_to_json(v: Any) -> Any:
    if isinstance(v, N.PlanNode):
        return {"@node": plan_to_dict(v)}
    if isinstance(v, DataType):
        return {"@type": type_to_dict(v)}
    if isinstance(v, E.Expr):
        return {"@expr": expr_to_dict(v)}
    if isinstance(v, enum.Enum):
        return {"@enum": [type(v).__name__, v.name]}
    if type(v) in _SPEC_TYPES.values():
        return {"@spec": [type(v).__name__, {
            f.name: _value_to_json(getattr(v, f.name))
            for f in dataclasses.fields(v)}]}
    if isinstance(v, tuple):
        return {"@tuple": [_value_to_json(x) for x in v]}
    if isinstance(v, list):
        return [_value_to_json(x) for x in v]
    return v


def _value_from_json(v: Any, device) -> Any:
    if isinstance(v, dict):
        if "@node" in v:
            return plan_from_dict(v["@node"], device)
        if "@type" in v:
            return type_from_dict(v["@type"])
        if "@expr" in v:
            return expr_from_dict(v["@expr"])
        if "@enum" in v:
            cls_name, member = v["@enum"]
            return getattr(N, cls_name)[member]
        if "@spec" in v:
            cls_name, fields = v["@spec"]
            return _SPEC_TYPES[cls_name](**{
                k: _value_from_json(x, device) for k, x in fields.items()})
        if "@tuple" in v:
            return tuple(_value_from_json(x, device) for x in v["@tuple"])
    if isinstance(v, list):
        return [_value_from_json(x, device) for x in v]
    return v


def plan_to_dict(node: N.PlanNode) -> dict:
    from velox_tpu_torch.serial import serialize_page

    d: Dict[str, Any] = {"@class": type(node).__name__}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if type(node).__name__ == "ValuesNode" and f.name == "batches":
            d[f.name] = {"@pages": [
                base64.b64encode(serialize_page(b)).decode() for b in v]}
            continue
        d[f.name] = _value_to_json(v)
    return d


def plan_from_dict(d: dict, device=None) -> N.PlanNode:
    """The plan of ``d``; a ValuesNode's pages load on ``device``
    (``None``: the card)."""
    from velox_tpu_torch.serial import deserialize_page

    cls = _NODE_TYPES[d["@class"]]
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, dict) and "@pages" in v:
            kwargs[f.name] = tuple(
                deserialize_page(base64.b64decode(p), device)
                for p in v["@pages"])
            continue
        kwargs[f.name] = _value_from_json(v, device)
    return cls(**kwargs)


def plan_to_json(node: N.PlanNode) -> str:
    return json.dumps(plan_to_dict(node), separators=(",", ":"))


def plan_from_json(s: str, device=None) -> N.PlanNode:
    return plan_from_dict(json.loads(s), device)
