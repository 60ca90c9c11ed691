"""repro_torch: the PyTorch/CUDA port of the federated asynchronous
AdaBoost system, beside the JAX package ``repro`` that it is held against.

The package mirrors ``repro``'s layout module for module and imports
neither JAX nor anything of ``repro``.  Its entry points run on the CUDA
card unless the caller asks for the CPU.
"""
