from repro_torch.serving.engine import Engine, GenerationConfig

__all__ = ["Engine", "GenerationConfig"]
