"""hymba-1.5b [arXiv:2411.13676] — hybrid: parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        rope_theta=10_000.0,
        source="arXiv:2411.13676",
    )
)
