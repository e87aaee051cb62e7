"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel ported.

All four are ported: ``decode_attention`` (``csrc/decode_attention.cu``),
the ``flash_attention`` forward (``csrc/flash_attention.cu``), the Mamba2
SSD scan ``mamba2_ssd`` (``csrc/mamba2_ssd.cu``) and the stabilized
parallel mLSTM ``mlstm`` (``csrc/mlstm.cu``); each module holds the
device-dispatching wrapper (``decode_attention``, ``flash_attention``,
``ssd``, ``mlstm``, each with a ``launches`` counter) and its plain PyTorch
version.
Kernels are built with ``nvcc`` at first use (``_build.py``), never at
import.
"""

from . import decode_attention, flash_attention, mamba2_ssd, mlstm, ops, ref

__all__ = ["decode_attention", "flash_attention", "mamba2_ssd", "mlstm", "ops", "ref"]
