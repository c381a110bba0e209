"""C-NMT collaborative inference, ported to PyTorch and CUDA.

The package mirrors ``repro``'s layout module for module (``data``,
``core``, ``kernels``, ``nmt``, ``models``, ``runtime``), so every ported
module's reference sits at the same relative path in the JAX package.
It imports ``torch`` and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back (see
:func:`repro_torch.device.resolve_device`).  On a CUDA tensor the
attention wrappers in :mod:`repro_torch.kernels.ops` launch the
hand-written kernels under ``kernels/csrc``; on a CPU tensor they run
the plain PyTorch version beside each kernel.
"""

import torch

# Everything computes in float32, as the JAX reference does.  TF32 keeps
# about three decimal digits, which would break the 1e-5 parity with the
# reference, so it is switched off for matrix products and for cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
