"""physher_tpu_torch: the PyTorch/CUDA port of physher_tpu.

The same phylogenetic models as the JAX package, module for module, written
in PyTorch for one NVIDIA H100. Plain tensor code is PyTorch; the pruning
sweep and its gradient run in hand-written CUDA kernels on CUDA tensors
(``ops/fused.py`` for nucleotides, ``ops/wide.py`` for codons and amino
acids, sources in ``csrc/``), and in plain PyTorch on CPU tensors.
Nothing here imports jax or physher_tpu.

Precision policy: every constructor takes an explicit ``dtype`` and
``device``. Golden parity with the reference C implementation needs
float64; float32 is the fast path on the card.
"""

import torch

__version__ = "0.1.0"

# TF32 keeps about three decimal digits. The JAX package once lost ~54 logP
# units on fluA to a silent low-precision matmul, so float32 products stay
# full float32 here, for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
