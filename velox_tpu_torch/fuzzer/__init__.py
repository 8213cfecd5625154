"""Fuzzing harnesses (the port of ``velox_tpu/fuzzer``): the distributed
fuzzer (``run_plan_distributed`` against the serial ``run_plan``) and
the exchange fuzzer (pages through the streaming exchange). The JAX
package's other six fuzzers are not ported yet."""

from velox_tpu_torch.fuzzer.distributed_fuzzer import (  # noqa: F401
    draw_case, run_distributed_fuzz,
)
from velox_tpu_torch.fuzzer.exchange_fuzzer import (  # noqa: F401
    run_exchange_fuzz,
)
