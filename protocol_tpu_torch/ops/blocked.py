"""Blocked (matrix-free) Sinkhorn (``protocol_tpu/ops/blocked.py``):
BASELINE ladder #3 at 100,000 x 100,000, where the dense [P, T] cost
(40 GB) cannot exist.

Only the potentials u [P] and v [T] are kept; every pass recomputes the
cost from the encoded columns:

  v-update  per task, a logsumexp over all P of K + u;
  u-update  per provider, a logsumexp over all T of K + v (the plain
            version carries a running (max, sum-exp) across task tiles,
            as the reference's lax.scan does);

with K = -cost/eps, or -1e18 off the mask. Rounding: the plan mass of
(p, t) is monotone in u_p - cost/eps, so the plan's top-k entries per
task are a top-k candidate generation under the provider offset -eps*u,
which then feeds the eps-scaled sparse auction.

On a CUDA tensor the passes are kernel K14 (``csrc/blocked.cu``): one
feasibility launch at the top of each solve, which writes the mask as the
two bitmaps of a :class:`FeasibilityBits` (2 x P x T / 8 bytes: 2.5 GB at
100,000^2), then per iteration a u pass over the row-major bitmap and a v
pass over the column-major one, each scoring only the feasible cells. No
[P, T] or [P, tile] block of floats is allocated; the marginals, the
masks and the loop are torch glue on the card, with no host readback
inside the loop. The rounding runs K1's biased forward launch, K2 and K9.
On a CPU tensor every function is the plain torch transcription below,
which divides by a 0-d tensor on the cost's device (a true f32 division,
as the kernel's and the reference's; CUDA torch would multiply by the
reciprocal of a Python scalar, one bit off). :func:`pack_feasibility` and
:func:`make_k_block_bits` are the plain versions of the bitmaps and of
the passes that read them.
"""

from __future__ import annotations

import dataclasses

import torch

from protocol_tpu_torch.ops.assign import AssignResult
from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix
from protocol_tpu_torch.ops.encoding import (
    EncodedProviders,
    EncodedRequirements,
    slice_requirements,
)
from protocol_tpu_torch.ops.sparse import assign_auction_sparse_scaled, candidates_topk

_NEG = -1e18


def make_k_block(ep, er, weights, eps, tile: int):
    """Factory for the streamed Gibbs-kernel block K[:, t0:t0+tile] =
    -cost/eps with infeasible entries at _NEG (the plain version of what
    K14 recomputes per cell)."""
    eps_t = torch.tensor(eps, dtype=torch.float32, device=ep.gpu_count.device)

    def k_block(t0: int) -> torch.Tensor:
        cost, _ = cost_matrix(ep, slice_requirements(er, t0, tile), weights)
        return torch.where(cost < INFEASIBLE * 0.5, -cost / eps_t, _NEG)

    return k_block


@dataclasses.dataclass(frozen=True)
class FeasibilityBits:
    """The mask of one solve as two bitmaps of u32 words, held in int32
    tensors on one device: ``rows`` [P, ceil(T/32)], bit j of word w set
    where cell (p, 32w + j) is feasible; ``cols`` [T, ceil(P/32)], bit j of
    word w set where cell (32w + j, t) is. Pad bits are 0. K14's
    feasibility launch writes one (``kernels.blocked_feasibility``) and
    every pass of the same solve reads it; :func:`pack_feasibility` builds
    the same words. Nothing keeps one across solves: the mask depends on
    the columns and the weights."""

    rows: torch.Tensor
    cols: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return self.rows.shape[0], self.cols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @staticmethod
    def nbytes(P: int, T: int) -> int:
        return 4 * (P * _words(T) + T * _words(P))

    @classmethod
    def empty(cls, P: int, T: int, device) -> FeasibilityBits:
        """Uninitialised words (the feasibility launch writes every one);
        raises with the byte count when the device cannot hold them."""
        try:
            return cls(torch.empty((P, _words(T)), dtype=torch.int32, device=device),
                       torch.empty((T, _words(P)), dtype=torch.int32, device=device))
        except torch.OutOfMemoryError as e:
            raise RuntimeError(f"K14's feasibility bitmaps need {cls.nbytes(P, T)} bytes on "
                               f"{device} for P={P}, T={T}: {e}") from e

    def check(self, P: int, T: int, device, what: str) -> None:
        """Raise unless these are the bitmaps of a P x T solve on ``device``."""
        good = (self.rows.shape == (P, _words(T)) and self.cols.shape == (T, _words(P))
                and self.rows.device == device and self.cols.device == device
                and self.rows.dtype == self.cols.dtype == torch.int32
                and self.rows.is_contiguous() and self.cols.is_contiguous())
        if not good:
            raise ValueError(f"{what}: the feasibility bitmaps are of a {self.shape[0]} x "
                             f"{self.shape[1]} solve on {self.device}, not of P={P}, T={T} on "
                             f"{device}")


def _words(n: int) -> int:
    return (n + 31) // 32


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """[n, m] bool -> [n, ceil(m/32)] int32 words: bit j of word w is
    mask[:, 32w + j], pad bits 0."""
    n, m = mask.shape
    pad = _words(m) * 32 - m
    if pad:
        mask = torch.cat([mask, mask.new_zeros((n, pad))], dim=1)
    shift = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (mask.reshape(n, -1, 32).to(torch.int64) << shift).sum(dim=2)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_words(words: torch.Tensor, m: int) -> torch.Tensor:
    """[n, W] int32 words -> [n, m] bool, the inverse of :func:`pack_words`."""
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shift) & 1).reshape(words.shape[0], -1)[:, :m].bool()


def pack_feasibility(ep, er, weights, chunk: int = 1024) -> FeasibilityBits:
    """The plain version of K14's bitmaps: make_k_block's mask (cost <
    INFEASIBLE/2) over task chunks of ``chunk`` (a multiple of 32, so no
    row-major word spans two chunks), packed in both layouts."""
    if chunk < 32 or chunk % 32:
        raise ValueError(f"chunk={chunk} must be a positive multiple of 32")
    P, T = ep.gpu_count.shape[0], er.cpu_cores.shape[0]
    dev = ep.gpu_count.device
    bits = FeasibilityBits(torch.empty((P, _words(T)), dtype=torch.int32, device=dev),
                           torch.empty((T, _words(P)), dtype=torch.int32, device=dev))
    for t0 in range(0, T, chunk):
        cost, _ = cost_matrix(ep, slice_requirements(er, t0, chunk), weights)
        feas = cost < INFEASIBLE * 0.5
        bits.rows[:, t0 // 32:t0 // 32 + _words(feas.shape[1])] = pack_words(feas)
        bits.cols[t0:t0 + feas.shape[1]] = pack_words(feas.T)
    return bits


def make_k_block_bits(ep, er, weights, eps, tile: int, bits: FeasibilityBits,
                      layout: str = "rows"):
    """:func:`make_k_block` with its mask read from ``bits`` (the row-major
    words for ``layout="rows"``, the plain row pass's input; the
    column-major ones, transposed, for ``"cols"``, the column passes'): the
    same bits as make_k_block wherever ``bits`` holds its mask."""
    if layout not in ("rows", "cols"):
        raise ValueError(f"layout must be 'rows' or 'cols', got {layout!r}")
    P, T = ep.gpu_count.shape[0], er.cpu_cores.shape[0]
    bits.check(P, T, ep.gpu_count.device, "make_k_block_bits")
    eps_t = torch.tensor(eps, dtype=torch.float32, device=ep.gpu_count.device)

    def k_block(t0: int) -> torch.Tensor:
        cost, _ = cost_matrix(ep, slice_requirements(er, t0, tile), weights)
        n = cost.shape[1]
        if layout == "rows":
            w0 = t0 // 32
            feas = unpack_words(bits.rows[:, w0:_words(t0 + n)], t0 + n - 32 * w0)[:, t0 % 32:]
        else:
            feas = unpack_words(bits.cols[t0:t0 + n], P).T
        return torch.where(feas, -cost / eps_t, _NEG)

    return k_block


def feasibility_scan(k_block, num_providers: int, starts):
    """One streaming pass: (row_any [P], col_any_tiles [n_tiles, tile])."""
    rows, cols = [], []
    for t0 in starts:
        feas = k_block(int(t0)) > _NEG * 0.5
        rows.append(feas.any(dim=1))
        cols.append(feas.any(dim=0))
    return torch.stack(rows).any(dim=0), torch.stack(cols)


def streaming_row_logsumexp(k_block, v: torch.Tensor, starts, num_providers: int,
                            tile: int) -> torch.Tensor:
    """Row-wise logsumexp of K + v over all task tiles via a running
    (max, sum-exp) accumulator, the reference's scan order."""
    run_max = torch.full((num_providers,), _NEG, dtype=torch.float32, device=v.device)
    run_sum = torch.zeros(num_providers, dtype=torch.float32, device=v.device)
    for t0 in starts:
        t0 = int(t0)
        k = k_block(t0) + v[t0:t0 + tile][None, :]
        new_max = torch.maximum(run_max, k.amax(dim=1))
        run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(k - new_max[:, None]).sum(dim=1)
        run_max = new_max
    return run_max + torch.log(torch.clamp(run_sum, min=1e-30))


def column_logsumexp(k_block, u: torch.Tensor, starts) -> torch.Tensor:
    """Column-wise logsumexp of K + u, a full column per task tile (the
    reference's v step): [T]."""
    parts = []
    for t0 in starts:
        k = k_block(int(t0)) + u[:, None]
        blk_max = k.amax(dim=0)
        s = torch.exp(k - blk_max[None, :]).sum(dim=0)
        parts.append(blk_max + torch.log(torch.clamp(s, min=1e-30)))
    return torch.cat(parts)


def _tile_starts(T: int, tile: int) -> range:
    if T % tile != 0:
        raise ValueError(f"T={T} not divisible by tile={tile}; pad requirements")
    return range(0, T, tile)


def sinkhorn_potentials_blocked(
    ep: EncodedProviders,
    er: EncodedRequirements,
    weights: CostWeights | None = None,
    eps: float = 0.05,
    num_iters: int = 50,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-domain potentials (u [P], v [T]) without materialising [P, T].

    Each iteration is a u pass then a v pass, from u0 = v0 = 0; the
    marginals are equalised to min(P_valid, T_valid) over the providers
    and tasks with a feasible cell, and u, v are -1e18 elsewhere. On a
    CUDA tensor the passes are K14's launches (``csrc/blocked.cu``), over
    the bitmaps its feasibility launch writes at the top of the solve."""
    from protocol_tpu_torch import kernels

    if weights is None:
        weights = CostWeights()
    P = ep.gpu_count.shape[0]
    T = er.cpu_cores.shape[0]
    starts = _tile_starts(T, tile)
    dev = ep.gpu_count.device
    on_card = ep.gpu_count.is_cuda
    k_block = None if on_card else make_k_block(ep, er, weights, eps, tile)

    # feasibility pass -> balanced marginals (ops/assign.py semantics)
    if on_card:
        row_any, col_any, bits = kernels.blocked_feasibility(ep, er, weights)
    else:
        row_any, col_tiles = feasibility_scan(k_block, P, starts)
        col_any = col_tiles.reshape(T)
    np_valid = torch.clamp(row_any.sum(), min=1)
    nt_valid = torch.clamp(col_any.sum(), min=1)
    m = torch.minimum(np_valid, nt_valid).to(torch.float32)
    log_a = torch.where(row_any, torch.log(m / np_valid.to(torch.float32)), _NEG)
    log_b = torch.where(col_any, torch.log(m / nt_valid.to(torch.float32)), _NEG)

    u = torch.zeros(P, dtype=torch.float32, device=dev)
    v = torch.zeros(T, dtype=torch.float32, device=dev)
    for _ in range(num_iters):
        if on_card:
            lse_u = kernels.blocked_row_lse(ep, er, weights, eps, v, bits)
        else:
            lse_u = streaming_row_logsumexp(k_block, v, starts, P, tile)
        u = torch.where(row_any, log_a - lse_u, _NEG)
        if on_card:
            lse_v = kernels.blocked_col_lse(ep, er, weights, eps, u, bits)
        else:
            lse_v = column_logsumexp(k_block, u, starts)
        v = torch.where(col_any, log_b - lse_v, _NEG)
    return u, v


def plan_guided_rounding(
    ep: EncodedProviders,
    er: EncodedRequirements,
    u: torch.Tensor,
    weights: CostWeights | None = None,
    eps: float = 0.05,
    tile: int = 1024,
    k: int = 32,
) -> AssignResult:
    """The rounding of :func:`assign_sinkhorn_blocked` from given provider
    potentials ``u`` (the reference's body after the potentials, which
    ``scripts/stage_s_100k.py`` inlines to reuse u): top-k candidates under
    the provider offset -eps*u, then the eps-scaled sparse auction."""
    if weights is None:
        weights = CostWeights()
    offset = -eps * torch.where(u > _NEG * 0.5, u, 0.0)
    cand_p, cand_c = candidates_topk(ep, er, weights, k=k, tile=tile, provider_offset=offset)
    return assign_auction_sparse_scaled(
        cand_p, cand_c, num_providers=ep.gpu_count.shape[0], eps_start=1.0, eps_end=0.02,
    )


def assign_sinkhorn_blocked(
    ep: EncodedProviders,
    er: EncodedRequirements,
    weights: CostWeights | None = None,
    eps: float = 0.05,
    num_iters: int = 50,
    tile: int = 1024,
    k: int = 32,
) -> AssignResult:
    """Full matrix-free Sinkhorn matching: blocked potentials -> plan-guided
    top-k candidates (provider offset -eps*u) -> sparse auction rounding."""
    if weights is None:
        weights = CostWeights()
    u, _v = sinkhorn_potentials_blocked(ep, er, weights, eps=eps, num_iters=num_iters, tile=tile)
    return plan_guided_rounding(ep, er, u, weights, eps=eps, tile=tile, k=k)
