"""LLaVA-NeXT 34B — VLM text backbone with anyres image tiling.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000.  The vision tower is a STUB per the
assignment: input_specs() provides 2880 precomputed anyres patch embeddings
(4 tiles + base image x 576 patches) prepended to the text sequence.
The anyres tiling of the vision side is the one assigned arch whose
workload shape matches QRMark's tile scheduling.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    frontend="vision",
    n_frontend_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
