from repro_torch.sharding.rules import AbstractMesh, Rules, make_rules, single_device_rules

__all__ = ["AbstractMesh", "Rules", "make_rules", "single_device_rules"]
