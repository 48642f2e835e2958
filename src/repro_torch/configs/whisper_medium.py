"""whisper-medium [arXiv:2212.04356] — enc-dec; conv/mel frontend STUBBED.

24L (decoder) + 24L (encoder) d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=51865.  ``input_specs`` provides precomputed frame embeddings.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        encoder_seq=1500,
        decoder_seq=448,
        rope_theta=10_000.0,  # we use RoPE in place of learned abs. pos.
        source="arXiv:2212.04356",
    )
)
