"""Granite-3.0 MoE 3B (800M active) — 40-expert top-8 fine-grained MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 32L d_model=1536 24H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
