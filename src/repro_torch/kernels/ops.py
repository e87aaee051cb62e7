"""Dispatch layer (attention half): models call these.

The rule is by the tensor's device, with no fallback: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(or the call raises).  Each name here is the kernel module's wrapper, which
makes that choice itself; tests that want the plain version on any device
call ``ref`` (or the kernel modules' ``*_plain``) directly.

Not ported yet: the chunked online-softmax path for Dv != D (MLA), the
Mamba2 SSD scan and the mLSTM cell (see ROADMAP.md).
"""

from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention

__all__ = ["decode_attention", "flash_attention"]
