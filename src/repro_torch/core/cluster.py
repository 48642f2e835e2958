"""Cluster topology specifications for the external-resource pools.

The paper's testbed (§6.1): a CPU cluster of 15 nodes (256 AMD cores,
2.4 TB RAM each) and a GPU cluster of 5 nodes (8 high-end GPUs, 3 TB host
RAM each), plus rate-limited API services.  These specs parameterize the
resource managers; nothing here touches JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CpuNodeSpec:
    name: str
    cores: int = 256
    numa_nodes: int = 2  # cores split evenly across NUMA domains
    memory_gb: float = 2400.0

    @property
    def cores_per_numa(self) -> int:
        return self.cores // self.numa_nodes


@dataclass(frozen=True)
class GpuNodeSpec:
    """One accelerator node.

    ``devices`` is 8 for the paper's NVLink nodes; for the TPU-slice
    adaptation (DESIGN.md §3) a "node" is a v5e tray and chunks are
    ICI-contiguous 1/2/4/8-chip slices — same radix, different constant
    names.  ``host_memory_gb`` bounds how many service snapshots EOE can
    keep host-resident (3 TB in the paper's testbed).
    """

    name: str
    devices: int = 8
    device_memory_gb: float = 80.0
    host_memory_gb: float = 3072.0
    restore_bw_gbps: float = 64.0  # host->device snapshot restore bandwidth


@dataclass(frozen=True)
class ApiResourceSpec:
    """A rate-limited external API (Basic manager, §5.1)."""

    name: str
    mode: str = "concurrency"  # "concurrency" | "quota"
    max_concurrency: int = 64
    quota: int = 1000  # tokens per period (quota mode)
    period_s: float = 60.0


@dataclass(frozen=True)
class ClusterSpec:
    cpu_nodes: Tuple[CpuNodeSpec, ...] = ()
    gpu_nodes: Tuple[GpuNodeSpec, ...] = ()
    apis: Tuple[ApiResourceSpec, ...] = ()

    @property
    def total_cores(self) -> int:
        return sum(n.cores for n in self.cpu_nodes)

    @property
    def total_devices(self) -> int:
        return sum(n.devices for n in self.gpu_nodes)


def paper_testbed(
    cpu_nodes: int = 15,
    cores_per_node: int = 256,
    gpu_nodes: int = 5,
    devices_per_node: int = 8,
) -> ClusterSpec:
    """The paper's §6.1 testbed (sizes overridable for scaled benchmarks)."""
    return ClusterSpec(
        cpu_nodes=tuple(
            CpuNodeSpec(name=f"cpu{i}", cores=cores_per_node) for i in range(cpu_nodes)
        ),
        gpu_nodes=tuple(
            GpuNodeSpec(name=f"gpu{i}", devices=devices_per_node)
            for i in range(gpu_nodes)
        ),
        apis=(
            ApiResourceSpec("google_search", mode="quota", quota=600, period_s=60.0),
            ApiResourceSpec("web_fetch", mode="concurrency", max_concurrency=128),
            ApiResourceSpec("pdf_parse", mode="concurrency", max_concurrency=32),
        ),
    )


def tpu_reward_pool(trays: int = 5, chips_per_tray: int = 8) -> ClusterSpec:
    """TPU-slice adaptation of the reward pool (DESIGN.md §3)."""
    return ClusterSpec(
        gpu_nodes=tuple(
            GpuNodeSpec(
                name=f"tray{i}",
                devices=chips_per_tray,
                device_memory_gb=16.0,  # v5e HBM
                restore_bw_gbps=100.0,
            )
            for i in range(trays)
        )
    )
