"""Mamba2 2.7B — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified] 64L d_model=2560 vocab=50280 ssm_state=128.
expand=2 -> d_inner=5120, head_dim=64 -> 80 SSM heads.  Runs long_500k
(O(1) state per token).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
