"""Phi-3.5-MoE 42B (6.6B active) — 16-expert top-2 MoE.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 (per expert) vocab=32064, MoE 16e top-2 in every layer.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2),
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
))
