"""kimi-k2-1t-a32b [arXiv:2507.20534; hf:moonshotai/Kimi-K2-Base] — trillion-parameter MoE.

61L d_model=7168 64H (GQA kv=8, head dim 112) per-expert d_ff=2048
vocab=163840, MoE 384 experts top-8, capacity factor 1.0.  The fields are
the JAX config's; only ``source`` differs, because the JAX config cites an
identifier that does not exist (``arXiv:2501.kimi2``).  Kimi K2 attends
with MLA (multi-head latent attention); the JAX config stands in GQA with
8 KV heads of dim 112 for it, and the port keeps JAX's.  At 1.04 T
parameters (31.1 B active) it runs at full width only in the dry-run
(``repro_torch.launch.dryrun``); its ``reduced()`` variant serves on a card.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        expert_d_ff=2048,
        num_experts=384,
        experts_per_token=8,
        vocab_size=163840,
        capacity_factor=1.0,  # trillion scale: a tight capacity keeps the dispatch buffer small
        rope_theta=50_000.0,
        source="arXiv:2507.20534; hf:moonshotai/Kimi-K2-Base",
    )
)
