"""Expression IR, parser and eager torch evaluation."""

from velox_tpu_torch.expr.ir import (  # noqa: F401
    Call, Cast, Expr, FieldRef, Lambda, Literal, TryExpr,
)
from velox_tpu_torch.expr.compiler import (  # noqa: F401
    ExprSet,
)
from velox_tpu_torch.expr.parser import parse_expr  # noqa: F401
