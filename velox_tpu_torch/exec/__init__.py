"""Execution runtime: operators, pipelines, the serial Task, spill and
the multi-fragment exchange."""

from velox_tpu_torch.exec.operator import Operator  # noqa: F401
from velox_tpu_torch.exec.task import (  # noqa: F401
    Task, make_operator, register_operator, run_plan, run_plan_grouped,
    run_plan_pydict,
)
from velox_tpu_torch.exec.fragments import (  # noqa: F401
    Fragment, OutputBufferManager, PartitionedOutputNode, fragment_batches,
    partitioned_output, run_fragments, run_fragments_streaming,
    streaming_fragment_batches,
)
from velox_tpu_torch.exec.exchange_net import (  # noqa: F401
    ExchangeServer, LocalExchangeSource, RemoteExchangeSource,
    StreamingBufferManager, consume_source,
)
from velox_tpu_torch.exec.spill import (  # noqa: F401
    MemoryManager, SpillableBuffer,
)
