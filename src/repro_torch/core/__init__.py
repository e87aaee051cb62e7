"""The serverless stateless-function runtime (port of `repro.core`): functions
(serialization, idempotency) -> scheduler (leases, retries, speculation) ->
executor (elastic container pool) -> wren (the map API).

Copies of the JAX package's modules with their imports rewritten to the
port, their logic unchanged except that callables ship with the standard
``pickle`` (see `functions`).  `bsp` and `ps` come with a later slice.
"""

from .executor import FaultPlan, Worker, WorkerPool, WorkerStats
from .functions import (
    FunctionSpec,
    TaskResult,
    TaskSpec,
    run_task,
    stage_input,
    stage_inputs,
)
from .futures import ALL_COMPLETED, ANY_COMPLETED, ALWAYS, ResultFuture, get_all, wait
from .resources import LAMBDA_2017, TPU_TASK_2026, ResourceLimits, io_compute_balance
from .scheduler import Scheduler, SchedulerConfig
from .wren import WrenExecutor

__all__ = [
    "WrenExecutor",
    "Scheduler",
    "SchedulerConfig",
    "WorkerPool",
    "Worker",
    "WorkerStats",
    "FaultPlan",
    "FunctionSpec",
    "TaskSpec",
    "TaskResult",
    "run_task",
    "stage_input",
    "stage_inputs",
    "ResultFuture",
    "wait",
    "get_all",
    "ALL_COMPLETED",
    "ANY_COMPLETED",
    "ALWAYS",
    "ResourceLimits",
    "LAMBDA_2017",
    "TPU_TASK_2026",
    "io_compute_balance",
]
