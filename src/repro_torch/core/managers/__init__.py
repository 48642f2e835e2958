from repro_torch.core.managers.base import Allocation, ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager

__all__ = [
    "Allocation",
    "ResourceManager",
    "BasicResourceManager",
    "CpuManager",
    "GpuManager",
]
