"""The serverless stateless-function runtime (port of `repro.core`): functions
(serialization, idempotency) -> scheduler (leases, retries, speculation) ->
executor (elastic container pool) -> wren (the map API) -> bsp / ps (BSP,
MapReduce, terasort and the parameter server, built on the one primitive).

Copies of the JAX package's modules with their imports rewritten to the
port, their logic unchanged except that callables ship with the standard
``pickle`` (see `functions`): the nested tasks of `bsp` and `ps` are
partials of module-level functions, and a user's map, reduce or gradient
function must pickle by reference.
"""

from .bsp import adopt_job, mapreduce, run_stage, terasort, verify_sorted, word_count
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
from .ps import ParameterServer, PSConfig, hogwild_sgd
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
    "mapreduce",
    "adopt_job",
    "word_count",
    "terasort",
    "verify_sorted",
    "run_stage",
    "ParameterServer",
    "PSConfig",
    "hogwild_sgd",
    "ResourceLimits",
    "LAMBDA_2017",
    "TPU_TASK_2026",
    "io_compute_balance",
]
