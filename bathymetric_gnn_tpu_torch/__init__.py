"""PyTorch/CUDA port of ``bathymetric_gnn_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports
``torch`` and ``numpy`` and nothing of JAX or of ``bathymetric_gnn_tpu``:
what it needs from the reference's framework-neutral modules it keeps as
its own copy. Every TPU kernel on a ported path is a hand-written CUDA C++
kernel (``csrc/``); its plain PyTorch version sits beside it and is what
runs for tensors on the CPU.
"""

__version__ = "0.1.0"
