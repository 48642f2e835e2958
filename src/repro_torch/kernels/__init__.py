from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
