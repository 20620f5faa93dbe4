"""PyTorch/CUDA port of the i-EXACT activation-compression system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``kernels``, ``engine``, ``graph``, ``optim``) module for module
and never imports it.  Entry point: :func:`repro_torch.graph.train.train_gnn`.
"""
import torch

# The reference computes every matmul in full float32.  TF32 keeps about
# three decimal digits, which would move the port off the reference's
# numbers (and change which stochastic-rounding codes a value lands on), so
# both TF32 switches stay off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
