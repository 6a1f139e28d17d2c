"""SeamlessM4T-medium — encoder-decoder multimodal (audio frontend stub).

[arXiv:2308.11596; hf] 12L (encoder) + 12L (decoder) d_model=1024 16H
(kv=16, i.e. MHA) d_ff=4096 vocab=256206.  The speech frontend is a STUB:
input_specs() provides precomputed frame embeddings consumed by the text
encoder; the decoder cross-attends to encoder output.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    is_encoder_decoder=True,
    n_enc_layers=12,
    frontend="audio",
    source="arXiv:2308.11596; hf",
))
