from repro_torch.models.model import ModelApi, build_model

__all__ = ["ModelApi", "build_model"]
