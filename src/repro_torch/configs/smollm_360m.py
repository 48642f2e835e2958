"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        rope_theta=10_000.0,
        source="hf:HuggingFaceTB/SmolLM-360M",
    )
)
