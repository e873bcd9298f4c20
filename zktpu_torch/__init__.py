"""zktpu_torch -- the PyTorch/CUDA build of the zktpu zero-knowledge framework.

The JAX package ``zktpu`` is the reference; this package stands beside it and
imports nothing of it. Plain tensor code is PyTorch, and the hot loops are CUDA
kernels written for Hopper (``csrc/``), built at first use on a CUDA tensor.

Field elements are ``num_limbs // 2`` little-endian 32-bit words in
``torch.int32`` tensors (the bit pattern of uint32): the same integers, in the
same Montgomery domain, as ``zktpu``'s 16-bit digits, with no padding bytes.
Every entry point takes its device from the field context, and the context
defaults to ``cuda``: it raises where there is no card rather than carrying on
on the CPU.
"""

__version__ = "0.1.0"
