"""Virtual devices for hermetic mesh runs (``protocol_tpu/utils/platform.py``).

The reference exposes n XLA host devices on one CPU with
``--xla_force_host_platform_device_count`` (``force_host_cpu``), so every
sharded kernel runs on a virtual mesh without accelerators. The port's
form is a process-level count of virtual devices per device type: with a
count n set for ``"cpu"`` or ``"cuda"``, :func:`visible_devices` yields n
views of that type's first device, so D shards live on one CPU or on one
card. Without a count, ``"cuda"`` is the cards ``torch.cuda.device_count()``
sees and ``"cpu"`` is one device.
"""

from __future__ import annotations

import torch

_VIRTUAL: dict[str, int] = {}


def force_virtual_devices(n: int | None, device_type: str = "cpu") -> int | None:
    """Expose ``n`` views of ``device_type``'s first device (``None``
    clears the count). Returns the previous count, so a caller can restore
    it."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if n is not None and n < 1:
        raise ValueError(f"need at least one virtual device, got {n}")
    prev = _VIRTUAL.get(device_type)
    if n is None:
        _VIRTUAL.pop(device_type, None)
    else:
        _VIRTUAL[device_type] = int(n)
    return prev


def visible_devices(device_type: str = "cuda") -> tuple[torch.device, ...]:
    """The devices a mesh of ``device_type`` may use, in order. A
    ``"cuda"`` request without a card raises: nothing moves to the CPU on
    its own."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh asked for, but no CUDA device is available; "
                "pass device='cpu' to run the plain torch path"
            )
        cards = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    elif device_type == "cpu":
        cards = (torch.device("cpu"),)
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    n = _VIRTUAL.get(device_type)
    return cards if n is None else (cards[0],) * n
