"""internvl2-1b [arXiv:2404.16821] — InternViT + InternLM2(Qwen2-0.5B) backbone.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The ViT frontend
is a STUB per the brief: ``input_specs`` provides precomputed patch
embeddings (256 patches) of the right shape.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        num_patches=256,
        rope_theta=1_000_000.0,
        source="arXiv:2404.16821",
    )
)
