"""Fuzzing harnesses (the port of ``velox_tpu/fuzzer``).

Analog of velox's fuzzer family (velox/expression/fuzzer/
ExpressionFuzzer.h:33, vector/fuzzer/VectorFuzzer.h:77): random vectors,
expression trees and plans evaluated by the engine and independently by
a plain-Python reference evaluator, or run through several physical
strategies that must agree; any mismatch is a bug. The vector,
expression, window, join, plan and aggregation fuzzers, the distributed
fuzzer (``run_plan_distributed`` against the serial ``run_plan``) and
the exchange fuzzer (pages through the streaming exchange). For a seed
each draws the JAX package's cases. Every entry point runs on the card
unless it is given ``device="cpu"`` (or a CPU mesh).
"""

from velox_tpu_torch.fuzzer.vector_fuzzer import VectorFuzzer  # noqa: F401
from velox_tpu_torch.fuzzer.expression_fuzzer import (  # noqa: F401
    ExpressionFuzzer, run_expression_fuzz,
)
from velox_tpu_torch.fuzzer.window_fuzzer import run_window_fuzz  # noqa: F401
from velox_tpu_torch.fuzzer.join_fuzzer import run_join_fuzz  # noqa: F401
from velox_tpu_torch.fuzzer.plan_fuzzer import run_plan_fuzz  # noqa: F401
from velox_tpu_torch.fuzzer.aggregation_fuzzer import (  # noqa: F401
    run_aggregation_fuzz,
)
from velox_tpu_torch.fuzzer.distributed_fuzzer import (  # noqa: F401
    draw_case, run_distributed_fuzz,
)
from velox_tpu_torch.fuzzer.exchange_fuzzer import (  # noqa: F401
    run_exchange_fuzz,
)
