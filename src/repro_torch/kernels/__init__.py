"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel ported.

Ported: ``decode_attention`` (``csrc/decode_attention.cu``) and the
``flash_attention`` forward (``csrc/flash_attention.cu``); each module
holds the device-dispatching wrapper (same name as the module, with a
``launches`` counter) and its plain PyTorch version (from ``ref.py``).
Kernels are built with ``nvcc`` at first use (``_build.py``), never at
import.
"""

from . import decode_attention, flash_attention, ops, ref

__all__ = ["decode_attention", "flash_attention", "ops", "ref"]
