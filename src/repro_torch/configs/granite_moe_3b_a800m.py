"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base] — MoE.

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 40 experts top-8.  The fields are the JAX config's; only ``source``
differs, because those widths are granite-3.0-3b-a800m's (the JAX config
cites granite-3.0-1b-a400m).  Granite's embedding/residual/attention
multipliers and tied embeddings are not modelled, as in the JAX package.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,
        expert_d_ff=512,
        num_experts=40,
        experts_per_token=8,
        vocab_size=49155,
        rope_theta=10_000.0,
        source="hf:ibm-granite/granite-3.0-3b-a800m-base",
    )
)
