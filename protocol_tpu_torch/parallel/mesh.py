"""The provider mesh and its collectives (``protocol_tpu/parallel/mesh.py``).

A mesh is an ordered tuple of ``torch.device``s, one per shard, over the
one axis the scheduler shards (``"p"``). A device may repeat, through the
virtual count of :mod:`protocol_tpu_torch.utils.platform`, so D shards
can live on one card or on the CPU, as the reference's virtual host mesh
lets D XLA devices live on one CPU.

The collectives of the sharded bodies live here, each once: a sharded
body holds one tensor per shard (a list in shard order) and combines them
by copying every part to the mesh's first device and reducing there into
a fresh tensor, so two shards on one device never alias an input with an
output. Every reduction but one is exact in any order: max, min, integer
sums and concatenation. The one whose bits depend on the order is the
float sum ``psum_float``, so it always adds the parts in shard order and
gives the same bits on every run. The combined result of ``pmax`` /
``pmin`` / ``psum`` / ``psum_float`` and a ``broadcast`` tensor come back
once per shard, on the shard's device; shards that share a device share
that tensor, so it is read-only.

Shards on distinct cards are written for (torch orders a cross-device
copy after both cards' current streams, and every kernel wrapper makes
its inputs' card the current device) but have not run: every run so far
holds the shards on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from protocol_tpu_torch.utils.platform import visible_devices

PROVIDER_AXIS = "p"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in shard order over the provider axis."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        """``{"p": D}``, the reference's spelling of the mesh's size."""
        return {PROVIDER_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    num_devices: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """1-D mesh over the first ``num_devices`` visible devices of
    ``device``'s type (default: all). Asking for more than are visible
    raises, as the reference does."""
    devices = visible_devices(torch.device(device).type)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return Mesh(tuple(devices))


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def shard_rows(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Dim 0 of ``t`` cut into ``mesh.size`` equal parts, part s on shard
    s's device (a view where the device is already right)."""
    n = t.shape[0] // mesh.size
    return [t[s * n:(s + 1) * n].to(d) for s, d in enumerate(mesh.devices)]


def replicate(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """One owned copy of ``t`` per shard: replicas a shard updates in place
    never share storage."""
    return [t.to(d, copy=True) for d in mesh.devices]


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The parts concatenated along dim 0 in shard order, on the first
    device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _combine(parts: Sequence[torch.Tensor], mesh: Mesh, reduce) -> list[torch.Tensor]:
    return broadcast(reduce(torch.stack([p.to(mesh.devices[0]) for p in parts])), mesh)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Elementwise max over the shards, once per shard (read-only)."""
    return _combine(parts, mesh, lambda s: s.amax(0))


def pmin(parts: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Elementwise min over the shards, once per shard (read-only)."""
    return _combine(parts, mesh, lambda s: s.amin(0))


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Elementwise integer sum over the shards, in the parts' dtype, once
    per shard (read-only). A float sum is ``psum_float``'s."""
    if parts[0].is_floating_point():
        raise TypeError("psum sums integers; a float sum is psum_float (in shard order)")
    return _combine(parts, mesh, lambda s: s.sum(0, dtype=s.dtype))


def psum_float(parts: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Elementwise float sum over the shards, added in shard order (((p0 +
    p1) + p2) + ...), so its bits do not depend on a reduction's order;
    once per shard (read-only)."""
    dev0 = mesh.devices[0]
    out = parts[0].to(dev0, copy=True)
    for p in parts[1:]:
        out += p.to(dev0)
    return broadcast(out, mesh)


def broadcast(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """``t`` once per shard, on the shard's device (read-only: shards on
    ``t``'s device share it)."""
    return [t.to(d) for d in mesh.devices]
