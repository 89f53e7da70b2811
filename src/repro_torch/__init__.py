"""ERCache on PyTorch + hand-written CUDA kernels for NVIDIA Hopper.

The twin of the JAX package ``repro``, module for module. It imports
``torch`` and numpy, never JAX and nothing of ``repro``. Entry points run
on the card (``device="cuda"``, ``backend="cuda"``) unless the caller asks
for the CPU and the plain ``"torch"`` backend, as the tests do.
"""
