"""Execution runtime: operators, pipelines and the serial Task driver."""

from velox_tpu_torch.exec.operator import Operator  # noqa: F401
from velox_tpu_torch.exec.task import (  # noqa: F401
    Task, run_plan, run_plan_pydict,
)
