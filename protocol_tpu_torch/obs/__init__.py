"""The port's switch for the observability plane (the part of
``protocol_tpu/obs/__init__.py`` the arena and the seam read), the span
tracer (``obs/spans.py``) and the quality pass (``obs/quality.py``), both
copied."""

from __future__ import annotations

import os

from protocol_tpu_torch.obs import spans

__all__ = ["enabled", "set_enabled", "spans"]

# the same PROTOCOL_TPU_OBS flag the reference reads; the tracer's enabled
# bit follows it (set_enabled keeps them in lockstep)
_ENABLED = os.environ.get("PROTOCOL_TPU_OBS", "1").strip().lower() not in (
    "0", "off", "false", "no",
)
spans.TRACER.enabled = _ENABLED


def enabled() -> bool:
    """Whether the observability plane is on (default yes)."""
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Toggle the plane, span tracer included, at runtime."""
    global _ENABLED
    _ENABLED = bool(flag)
    spans.TRACER.enabled = bool(flag)
