"""PyTorch + CUDA port of ``monorec_tpu`` for NVIDIA Hopper.

The layout mirrors ``monorec_tpu`` module for module (``geometry``,
``ops``, ``models``, ``convert``, ``data``, ``cli``), so each function has
an obvious reference. Tensors are NCHW. The package imports ``torch`` and
``numpy`` only; the hand-written CUDA kernels are built from the sources in
``ops/cuda`` at their first launch.

Kernel dispatch follows the device of the tensors: a kernel wrapper
launches its CUDA kernel on CUDA tensors and runs the kernel's plain
PyTorch version on CPU tensors. There is no other switch.

``tracing`` has no counterpart in ``monorec_tpu``: spans at the forward's
and the training step's layer boundaries, off unless a caller turns them on.
"""
