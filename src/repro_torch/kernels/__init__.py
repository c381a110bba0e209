"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch versions.  :mod:`repro_torch.kernels.ops` is the
public entry; ``_build`` compiles the sources with ``nvcc`` at first use
on the card, never at import."""
