"""H2O-Danube3 4B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified] 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, SWA window 4096.  The sliding window bounds the KV cache, so
this arch runs the long_500k shape (sub-quadratic).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,
    sliding_window=4096,
    source="arXiv:2401.16818; unverified",
))
