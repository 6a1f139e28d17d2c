"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2.  Within every 8-layer group, layer 4 is
attention and the other 7 are Mamba (1:7); every other layer uses the MoE
MLP (Jamba applies MoE at period 2).  We standardise the SSM blocks on
Mamba-2/SSD with d_state=128 (Jamba-1 used Mamba-1 d_state=16): SSD's
matmul form is the reference's formulation, and the port keeps it.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, period=2, offset=1),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
    attn_period=8,
    attn_offset=4,
    source="arXiv:2403.19887; hf",
))
