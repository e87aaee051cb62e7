"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel ported.

Ported: ``decode_attention`` (``csrc/decode_attention.cu``), the
``flash_attention`` forward (``csrc/flash_attention.cu``) and the Mamba2
SSD scan ``mamba2_ssd`` (``csrc/mamba2_ssd.cu``); each module
holds the device-dispatching wrapper (``decode_attention``,
``flash_attention``, ``ssd``, each with a ``launches`` counter) and its
plain PyTorch version.
Kernels are built with ``nvcc`` at first use (``_build.py``), never at
import.
"""

from . import decode_attention, flash_attention, mamba2_ssd, ops, ref

__all__ = ["decode_attention", "flash_attention", "mamba2_ssd", "ops", "ref"]
