"""PyTorch + CUDA port of ``protocol_tpu``'s solve path, for one NVIDIA
Hopper card (H100, ``sm_90a``).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``parallel/``, ``sched/``, ``services/``, ``proto/``,
``obs/``, ``trace/``, ``native/``) so each counterpart is easy to find,
and imports nothing of it: what it needs of the reference's host modules
is copied here.

Entry points take an explicit ``device``. The default is ``"cuda"``;
without a card they raise unless the caller asks for ``device="cpu"``.
On a CUDA tensor, the hand kernels under ``csrc/`` run (built with
``nvcc`` at first use, see :mod:`protocol_tpu_torch.kernels`); on a CPU
tensor, each kernel's plain torch version in the same module runs.
"""

from protocol_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
