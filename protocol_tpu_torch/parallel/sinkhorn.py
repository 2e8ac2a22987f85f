"""The provider-sharded blocked Sinkhorn (``protocol_tpu/parallel/sinkhorn.py``).

Providers, and their potential u, are cut over the mesh in shard order;
the tasks and v are replicated. Per iteration:

  u step  shard-local: each shard's logsumexp over all tasks of K + v for
          its own provider rows (no collective);
  v step  each shard's per-column partial over its own provider rows,
          combined across the shards.

On a CUDA tensor every pass is kernel K14 (``csrc/blocked.cu``) over one
shard's rows: the feasibility launch and the row pass as the one-device
potentials run them, and the column pass in its partial mode
(``kernels.blocked_col_partial``), which writes the online (max, sum-exp)
pair (m_s, s_s) of each column over the shard's rows. On a CPU tensor
the plain versions run the same schedule: per shard ``make_k_block`` over
its rows, the row pass, and the column partials (``_col_partial_plain``,
a full column per task tile).

Either way the v step combines the partials (``_combine_col_partials``):
gmax = ``pmax`` of the m_s, then gsum = sum_s s_s * exp(m_s - gmax) by
the in-order ``psum_float``, and lse = gmax + log(max(gsum, 1e-30)); a
shard with m_s = -inf (no feasible cell in that column) adds 0. Each
cell is scored once per pass, where the reference's schedule scores the
v step's block twice (a max pass, then a sum pass); the exps are summed
in another order, so the potentials agree with the reference within a
tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from protocol_tpu_torch.ops.blocked import (
    _NEG,
    _tile_starts,
    feasibility_scan,
    make_k_block,
    streaming_row_logsumexp,
)
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import EncodedProviders, EncodedRequirements
from protocol_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    broadcast,
    pmax,
    psum,
    psum_float,
    shard_rows,
)


def _shard_providers(ep: EncodedProviders, mesh: Mesh) -> list[EncodedProviders]:
    """Each shard's provider rows (views where the device is already right)."""
    cols = {f.name: shard_rows(getattr(ep, f.name), mesh) for f in dataclasses.fields(ep)}
    return [EncodedProviders(**{n: c[s] for n, c in cols.items()}) for s in range(mesh.size)]


def _replicate_requirements(er: EncodedRequirements, mesh: Mesh) -> list[EncodedRequirements]:
    """The requirement columns once per shard (read-only: shards on their
    device share them)."""
    cols = {f.name: broadcast(getattr(er, f.name), mesh) for f in dataclasses.fields(er)}
    return [EncodedRequirements(**{n: c[s] for n, c in cols.items()}) for s in range(mesh.size)]


def _col_partial_plain(k_block, u: torch.Tensor, starts) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K14's partial column mode over one shard's rows:
    per task, (m, s) of K + u over the feasible cells, m = -inf and s = 0
    where the shard has none. A full column per task tile, as the
    reference's v step takes it."""
    ms, ss = [], []
    for t0 in starts:
        k = k_block(int(t0))
        x = torch.where(k > _NEG * 0.5, k + u[:, None], -torch.inf)
        m = x.amax(dim=0)
        ms.append(m)
        ss.append(torch.where(m > -torch.inf, torch.exp(x - m[None, :]).sum(dim=0), 0.0))
    return torch.cat(ms), torch.cat(ss)


def _combine_col_partials(ms, ss, mesh: Mesh) -> torch.Tensor:
    """The shards' (m_s, s_s) pairs combined into the column logsumexp [T]
    on the first device: gmax = max m_s, gsum = sum of s_s * exp(m_s -
    gmax) in shard order (a shard with m_s = -inf adds 0; a column that is
    -inf in every shard ends at -inf), gmax + log(max(gsum, 1e-30))."""
    gmax = pmax(ms, mesh)
    terms = [torch.where(m > -torch.inf, s * torch.exp(m - g), 0.0)
             for m, s, g in zip(ms, ss, gmax)]
    gsum = psum_float(terms, mesh)[0]
    return gmax[0] + torch.log(torch.clamp(gsum, min=1e-30))


def sinkhorn_potentials_sharded(
    ep: EncodedProviders,
    er: EncodedRequirements,
    mesh: Mesh,
    weights: CostWeights | None = None,
    eps: float = 0.05,
    num_iters: int = 50,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-domain potentials (u [P], v [T]) with the providers sharded over
    ``mesh`` (``protocol_tpu/parallel/sinkhorn.py:120``): u gathered in
    shard order and v, both on the mesh's first device. P must divide by
    the mesh size and T by ``tile``. On a card the passes are K14's
    launches, one shard at a time."""
    from protocol_tpu_torch import kernels

    if weights is None:
        weights = CostWeights()
    Pn = ep.gpu_count.shape[0]
    T = er.cpu_cores.shape[0]
    D = mesh.size
    if Pn % D != 0:
        raise ValueError(f"P={Pn} not divisible by mesh size {D}; pad first")
    starts = _tile_starts(T, tile)
    on_card = ep.gpu_count.is_cuda
    eps_l = _shard_providers(ep, mesh)
    er_l = _replicate_requirements(er, mesh)
    k_blocks = None if on_card else [make_k_block(e, r, weights, eps, tile)
                                     for e, r in zip(eps_l, er_l)]

    # feasibility per shard: col_any from the psum of the shards' column
    # flags, np_valid from the psum of their row counts
    if on_card:
        feas = [kernels.blocked_feasibility(e, r, weights) for e, r in zip(eps_l, er_l)]
    else:
        feas = [feasibility_scan(kb, Pn // D, starts) for kb in k_blocks]
    row_any = [f[0] for f in feas]
    col_any = psum([f[1].reshape(T).to(torch.int32) for f in feas], mesh)[0] > 0
    np_valid = torch.clamp(psum([r.sum().to(torch.int32).reshape(1) for r in row_any], mesh)[0],
                           min=1)[0]
    nt_valid = torch.clamp(col_any.sum(), min=1)
    m = torch.minimum(np_valid, nt_valid).to(torch.float32)
    log_a = [torch.where(r, torch.log(m.to(r.device) / np_valid.to(r.device, torch.float32)),
                         _NEG) for r in row_any]
    log_b = torch.where(col_any, torch.log(m / nt_valid.to(torch.float32)), _NEG)

    dev0 = mesh.devices[0]
    u_parts = [torch.zeros(Pn // D, dtype=torch.float32, device=d) for d in mesh.devices]
    v = torch.zeros(T, dtype=torch.float32, device=dev0)
    for _ in range(num_iters):
        # u step: shard-local, over the shard's rows against the replicated v
        v_parts = broadcast(v, mesh)
        for s in range(D):
            if on_card:
                lse_u = kernels.blocked_row_lse(eps_l[s], er_l[s], weights, eps, v_parts[s])
            else:
                lse_u = streaming_row_logsumexp(k_blocks[s], v_parts[s], starts, Pn // D, tile)
            u_parts[s] = torch.where(row_any[s], log_a[s] - lse_u, _NEG)
        # v step: the shards' column partials combined
        if on_card:
            parts = [kernels.blocked_col_partial(e, r, weights, eps, u)
                     for e, r, u in zip(eps_l, er_l, u_parts)]
        else:
            parts = [_col_partial_plain(kb, u, starts) for kb, u in zip(k_blocks, u_parts)]
        lse_v = _combine_col_partials([p[0] for p in parts], [p[1] for p in parts], mesh)
        v = torch.where(col_any, log_b - lse_v, _NEG)
    return all_gather(u_parts, mesh), v
