"""Lambda-style resource limits + the paper's §4 resource-balance heuristic.

AWS Lambda circa the paper: 300 s max runtime, 1.5 GB RAM, 512 MB local
scratch, no root.  The executor enforces these limits on every task (virtual
runtime, measured payload sizes) so workloads that "don't fit Lambda" fail
the same way they would have in PyWren, and the BSP layer is forced into the
same task-granularity decisions (e.g. >= 2500 sort tasks per stage for 1TB).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.storage.perf_model import MB


@dataclass(frozen=True)
class ResourceLimits:
    max_runtime_s: float = 300.0
    memory_bytes: int = int(1.5 * 1024 * MB)  # 1.5 GiB-ish
    local_storage_bytes: int = int(512 * MB)

    def check_payload(self, nbytes: int, what: str) -> None:
        if nbytes > self.memory_bytes:
            raise MemoryError(
                f"{what} of {nbytes/1e9:.2f} GB exceeds container memory "
                f"{self.memory_bytes/1e9:.2f} GB"
            )

    def check_runtime(self, vtime_s: float) -> None:
        if vtime_s > self.max_runtime_s:
            raise TimeoutError(
                f"task virtual runtime {vtime_s:.1f}s exceeds limit "
                f"{self.max_runtime_s:.0f}s"
            )


LAMBDA_2017 = ResourceLimits()

# A 2026-scale serverless accelerator container (the §4 'more general
# hardware support will be available in the future' row): one TPU-slice task.
TPU_TASK_2026 = ResourceLimits(
    max_runtime_s=3600.0,
    memory_bytes=int(16 * 1024 * MB),
    local_storage_bytes=int(100 * 1024 * MB),
)


def io_compute_balance(
    memory_bytes: float, storage_bw_bytes_per_s: float, max_runtime_s: float
) -> dict:
    """The paper's §4 'Resource balance' heuristic.

    'each Lambda has around 35 MB/s bandwidth to S3 and can thus fill up its
    memory of 1.5GB in around 40s. Assuming it takes 40s to write output, we
    can see that the running time of 300s is appropriately proportioned for
    around 80s of I/O and 220s of compute.'

    Returns the proportioning and, inversely, the memory capacity a target
    running time supports ('this rule can be used to automatically determine
    memory capacity given a target running time').
    """
    fill_s = memory_bytes / storage_bw_bytes_per_s
    io_s = 2 * fill_s  # read input + write output
    compute_s = max(max_runtime_s - io_s, 0.0)
    return {
        "fill_seconds": fill_s,
        "io_seconds": io_s,
        "compute_seconds": compute_s,
        "io_fraction": io_s / max_runtime_s if max_runtime_s else float("inf"),
        # inverse rule: memory a runtime budget supports at this bandwidth,
        # keeping the same (io : compute) proportion as Lambda-2017.
        "memory_for_runtime": lambda runtime_s, io_frac=io_s / max_runtime_s: (
            0.5 * io_frac * runtime_s * storage_bw_bytes_per_s
        ),
    }
