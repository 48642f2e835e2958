"""Torch twins of the repository's ``examples/`` scripts, run as modules:
``python -m repro_torch.examples.agentic_rl_e2e``."""
