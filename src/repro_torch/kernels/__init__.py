"""Hand-written CUDA kernels and their plain PyTorch versions.

Importing the package switches TF32 off for float32 products and
convolutions: the reference's fp32 rung accumulates in full fp32, and
so do the plain versions when they run on the card.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
