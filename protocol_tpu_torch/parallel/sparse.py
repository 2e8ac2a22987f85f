"""The provider mesh's sharded passes and the churn-masked repair of the
persistent candidate structure (``protocol_tpu/parallel/sparse.py``).

  candidates_topk_bidir_sharded
        bidirectional generation with the tasks sharded over a
        :class:`~protocol_tpu_torch.parallel.mesh.Mesh`: each shard runs K1
        over its own task rows with the jitter keyed on their global ids,
        folds its reverse pools from the (INFEASIBLE, -1) carry, and the
        shards' [P, r] folds meet in :func:`_merge_rev_pools`. Bit-identical
        to the single-device pass (the reference's D-invariance contract).
  repair_topk_bidir
        the reference's ``repair_topk_bidir_sharded``: patches the
        generation parts (forward lists [T, k] and per-tile reverse pools
        [P, n_tiles*rt]) for the dirty provider and task rows, replays the
        reverse fold over the pools and re-merges. The result is
        bit-identical to a from-scratch pass plus merge on the current
        columns (the repaired == regen contract). With a ``mesh`` the enter
        scan is sharded and the fold replays at D lanes, as generation at D
        folds.
  assign_auction_sparse_sharded, assign_auction_sparse_scaled_sharded,
  assign_auction_sparse_warm_sharded
        the frontier auction with the tasks sharded over the mesh: one
        phase is rounds of per-shard bids combined across the shards
        (``_build_sharded_phase``), run in 256-round segments with the
        per-shard frontier refit between them (``_run_phase_sharded``).
        The per-shard frontier is min(frontier, T/D), so D changes the
        schedule: the results equal the reference's at the same D.

These functions hold hand kernels for Hopper (``csrc/``); each dispatches
on the device of its inputs, with no fallback: a CPU tensor takes the
plain torch version beside it, a CUDA tensor the kernel.

  repair_enter     -> K3 (``csrc/candidates.cu``, a list launch of K1's
                      layout), the reference's ``_build_repair_enter``; at
                      a jitter offset, a shard's part of
                      ``_build_repair_enter_sharded``
  forward_rows     -> K1's forward launch (``csrc/candidates.cu``),
                      the selection of ``_build_repair_forward``
  tile_min         -> K4 (``csrc/candidates.cu``), the dirty-column cost block
                      of ``_build_repair_forward`` reduced to per-(provider,
                      tile) minima
  reverse_blocks   -> K1 reverse, blocks variant (``csrc/candidates.cu``),
                      ``_build_repair_tile``
  repair_refold    -> K5 (``csrc/repair.cu``), ``_build_repair_refold`` +
                      ``_merge_rev_pools``, at ``d_fold`` lanes
  _segment         -> K16: where every shard lies on one card, its
                      segment launch (``csrc/auction.cu``, K2's cluster
                      kernel over D shards: 256 rounds of every shard a
                      launch); across cards each round of
                      ``_build_sharded_phase`` as three launches a shard
                      (``csrc/mesh_auction.cu``: bid, resolve, apply)
                      around the round's pmax and pmin
                      (``segment_route`` decides from the devices and the
                      shapes); the plain versions ``_round_*_plain`` run
                      every shard at once over stacked views of one device

Sharded generation runs K1's fused launch per shard (``csrc/candidates.cu``)
at the shard's jitter offset.

Every cell is scored with its global provider and task ids in the tie
jitter, so a recomputed subset lands on the exact cells of the full pass.
The reference pads every gather to a pow-2 bucket (``_pow2_pad``,
``_gather_rows``, ``pad_floors``) only to bound JAX retraces; here each
gather takes exactly the rows it needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from protocol_tpu_torch.kernels import (
    CARD_CHECK_EVERY, CTL_ASSIGNED, CTL_BEST, CTL_GO, CTL_IT, CTL_NB, CTL_OPEN, CTL_PENDING,
    CTL_ROWS, CTL_STALL, MESH_CTL,
)
from protocol_tpu_torch.ops.assign import _NEG, AssignResult, _invert
from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix, tie_jitter_ids
from protocol_tpu_torch.ops.encoding import (
    gather_providers,
    gather_requirements,
    slice_requirements,
)
from protocol_tpu_torch.ops.sparse import (
    _greedy_cleanup,
    _refuse_unported,
    _report_stall,
    _smallest_stable,
    _total_order,
    _unassign_unhappy,
    candidates_fused,
    frontier_bids,
    merge_reverse_candidates,
)
from protocol_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    pmax,
    pmin,
    psum,
    replicate,
    shard_rows,
)

# cost of "no dirty task here" in the per-(provider, tile) minima: above
# every real or infeasible cost, so it never flags a block
_PAD_COST = 1e18

# rows (tasks or providers) per plain-version cost block: [P, 1024] f32,
# the generation tile's memory envelope
_CHUNK = 1024


def _jittered(ep_rows, er_rows, weights, p_ids, t_ids):
    """Jittered cost [len(p_ids), len(t_ids)] of gathered rows, the jitter
    keyed on their global ids."""
    cost, _ = cost_matrix(ep_rows, er_rows, weights)
    jit = tie_jitter_ids(p_ids, t_ids)
    return torch.where(cost < INFEASIBLE * 0.5, cost + jit, cost)


def _as_ids(a, device) -> torch.Tensor:
    """Global row ids (array, list or tensor) as an int64 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64).ravel()
    return torch.as_tensor(np.asarray(a, np.int64).ravel(), device=device)


def _as_part(a, device) -> torch.Tensor:
    """A stored part as a tensor on ``device`` (a read-only array is copied)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


# ---------------- plain versions of the repair kernels ----------------


def _on(enc, device):
    """Encoded columns on ``device`` (the same tensors where they already lie
    there)."""
    return type(enc)(**{f.name: getattr(enc, f.name).to(device) for f in dataclasses.fields(enc)})


def _enter_plain(ep, er, weights, p_ids, thresh, offset: int = 0):
    """Plain torch version of K3: enter [T] bool, the jitter keyed on
    row + ``offset``."""
    T = er.num
    dev = thresh.device
    ep_d = gather_providers(ep, p_ids)
    enter = torch.zeros(T, dtype=torch.bool, device=dev)
    for t0 in range(0, T, _CHUNK):
        n = min(_CHUNK, T - t0)
        t_ids = torch.arange(t0 + offset, t0 + offset + n, device=dev)
        cost = _jittered(ep_d, slice_requirements(er, t0, n), weights, p_ids, t_ids)
        hit = (cost <= thresh[t0:t0 + n][None, :]) & (cost < INFEASIBLE * 0.5)
        enter[t0:t0 + n] = hit.any(dim=0)
    return enter


def _forward_rows_plain(ep, er, weights, k: int, t_ids):
    """Plain torch version of K1's forward launch over the task ids
    ``t_ids``: (p [R, k], c [R, k])."""
    p_all = torch.arange(ep.num, device=t_ids.device)
    out_p, out_c = [], []
    for lo in range(0, t_ids.numel(), _CHUNK):
        chunk = t_ids[lo:lo + _CHUNK]
        cost = _jittered(ep, gather_requirements(er, chunk), weights, p_all, chunk).T
        idx = _smallest_stable(cost, k)  # lax.top_k's order: lower index first
        cost_k = torch.gather(cost, 1, idx)
        out_p.append(torch.where(cost_k < INFEASIBLE * 0.5, idx.to(torch.int32), -1))
        out_c.append(cost_k)
    return torch.cat(out_p), torch.cat(out_c)


def _tile_min_plain(ep, er, weights, t_ids, tile: int, pad: float):
    """Plain torch version of K4: [P, n_tiles] minima over ``t_ids``."""
    P = ep.num
    dev = t_ids.device
    out = torch.full((P, er.num // tile), pad, dtype=torch.float32, device=dev)
    p_all = torch.arange(P, device=dev)
    for lo in range(0, t_ids.numel(), _CHUNK):
        chunk = t_ids[lo:lo + _CHUNK]
        cost = _jittered(ep, gather_requirements(er, chunk), weights, p_all, chunk)
        out.scatter_reduce_(1, (chunk // tile)[None, :].expand(P, -1), cost, "amin")
    return out


def _reverse_blocks_plain(ep, er, weights, tile: int, rt: int, blk_p, blk_j, pool_t, pool_c):
    """Plain torch version of K1's blocks variant: each flagged block's raw
    top-rt (first index among ties) written into the pools in place."""
    dev = pool_c.device
    for j in torch.unique(blk_j).tolist():
        t0 = j * tile
        tid = t0 + torch.arange(tile, dtype=torch.int32, device=dev)
        er_tile = slice_requirements(er, t0, tile)
        sj = blk_p[blk_j == j]
        for lo in range(0, sj.numel(), 4 * _CHUNK):
            sc = sj[lo:lo + 4 * _CHUNK]
            cost = _jittered(gather_providers(ep, sc), er_tile, weights, sc, tid)
            if rt == 1:
                jx = torch.argmin(cost, dim=1)[:, None]  # first index among ties
            else:
                jx = _smallest_stable(cost, rt)
            pool_t[sc, j * rt:(j + 1) * rt] = tid[jx]
            pool_c[sc, j * rt:(j + 1) * rt] = torch.gather(cost, 1, jx)


def _smallest_total(c: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of each row's n least costs in the total order, the earlier
    entry first among equal bits (``lax.top_k`` of the negation)."""
    return torch.sort(_total_order(c), dim=-1, stable=True).indices[..., :n]


def _merge_rev_pools(rev_c_all, rev_t_all, r: int):
    """Best r of the D per-lane [P, r] fold results (stable, in the total
    order), -1 where the cost is not below INFEASIBLE/2: (rev_t [P, r],
    rev_c). At D = 1 a stable top-r of r sorted entries, so only the mask
    acts."""
    D, P, _ = rev_c_all.shape
    rev_c_cat = rev_c_all.movedim(0, 1).reshape(P, D * r)
    rev_t_cat = rev_t_all.movedim(0, 1).reshape(P, D * r)
    m = _smallest_total(rev_c_cat, r)
    rev_c = torch.gather(rev_c_cat, 1, m)
    rev_t = torch.gather(rev_t_cat, 1, m)
    return torch.where(rev_c < INFEASIBLE * 0.5, rev_t, -1), rev_c


def _refold_plain(pool_t, pool_c, r: int, rt: int, d_fold: int = 1):
    """Plain torch version of K5: the generation fold replayed over the
    pools in ``d_fold`` lanes of consecutive tiles, each in tile order
    (stable top-r of carry then tile, the carry first, in the total order
    of ``lax.top_k``: -0 before +0, a negative NaN below every cost), then
    the lanes' merge."""
    P = pool_c.shape[0]
    ntl = pool_c.shape[1] // rt // d_fold
    lanes_c = pool_c.reshape(P, d_fold, ntl * rt).movedim(1, 0)  # [D, P, ntl*rt]
    lanes_t = pool_t.reshape(P, d_fold, ntl * rt).movedim(1, 0)
    rev_c = torch.full((d_fold, P, r), INFEASIBLE, dtype=torch.float32, device=pool_c.device)
    rev_t = torch.full((d_fold, P, r), -1, dtype=torch.int32, device=pool_c.device)
    for j in range(ntl):
        merged_c = torch.cat([rev_c, lanes_c[:, :, j * rt:(j + 1) * rt]], dim=2)
        merged_t = torch.cat([rev_t, lanes_t[:, :, j * rt:(j + 1) * rt]], dim=2)
        m = _smallest_total(merged_c, r)
        rev_c = torch.gather(merged_c, 2, m)
        rev_t = torch.gather(merged_t, 2, m)
    return _merge_rev_pools(rev_c, rev_t, r)


# ---------------- dispatch: kernel on a card, plain version on the CPU ----


def repair_enter(ep, er, weights, p_ids, thresh, offset: int = 0):
    """Tasks a dirty provider (global ids ``p_ids``) can enter: some fresh
    feasible jittered cost <= the task's stored k-th cost ``thresh`` [T]
    (``<=`` over-flags exact ties on purpose), the jitter keyed on row +
    ``offset`` (a mesh shard's first global row). Returns [T] bool."""
    if thresh.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.repair_enter(ep, er, weights, p_ids, thresh, offset=offset)
    return _enter_plain(ep, er, weights, p_ids, thresh, offset)


def repair_enter_sharded(ep, er, weights, p_ids, thresh, mesh: Mesh):
    """The enter scan with the tasks sharded over ``mesh`` (the reference's
    ``_build_repair_enter_sharded``): each shard scans its own rows at
    their global ids (:func:`repair_enter` at the shard's offset), and the
    shards' [T/D] masks are gathered in shard order."""
    Tl = er.num // mesh.size
    parts = []
    for s, dev in enumerate(mesh.devices):
        er_s = _on(slice_requirements(er, s * Tl, Tl), dev)
        parts.append(repair_enter(_on(ep, dev), er_s, weights, p_ids.to(dev),
                                  thresh[s * Tl:(s + 1) * Tl].to(dev), offset=s * Tl))
    return all_gather(parts, mesh)


def forward_rows(ep, er, weights, k: int, t_ids):
    """Exact forward top-k of the tasks ``t_ids`` (global ids):
    (p [R, k] i32 with -1 where infeasible, c [R, k])."""
    if t_ids.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.candidates_forward_rows(ep, er, weights, k, t_ids)
    return _forward_rows_plain(ep, er, weights, k, t_ids)


def tile_min(ep, er, weights, t_ids, tile: int):
    """Per (provider, tile), the least fresh jittered cost over the tasks
    ``t_ids`` (ascending, unique) in that tile, ``_PAD_COST`` elsewhere."""
    if t_ids.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.repair_tile_min(ep, er, weights, t_ids, tile, _PAD_COST)
    return _tile_min_plain(ep, er, weights, t_ids, tile, _PAD_COST)


def reverse_blocks(ep, er, weights, tile: int, rt: int, blk_p, blk_j, pool_t, pool_c) -> None:
    """Recompute the (blk_p[b], blk_j[b]) contribution blocks of the pools
    in place: raw top-rt, no -1 masking (pools persist raw)."""
    if pool_c.is_cuda:
        from protocol_tpu_torch import kernels

        if rt != 1:
            raise ValueError(
                f"K1 takes one reverse contribution per tile (rt=1), got rt={rt}: "
                "use a tile with T/tile >= reverse_r"
            )
        return kernels.candidates_reverse_blocks(ep, er, weights, tile, blk_p, blk_j, pool_t, pool_c)
    return _reverse_blocks_plain(ep, er, weights, tile, rt, blk_p, blk_j, pool_t, pool_c)


def repair_refold(pool_t, pool_c, r: int, rt: int, d_fold: int = 1):
    """Reverse edges from the pools, folded as generation over ``d_fold``
    shards folds them: (rev_t [P, r] with -1 padding, rev_c)."""
    if pool_c.is_cuda:
        from protocol_tpu_torch import kernels

        if rt != 1:
            raise ValueError(f"K5 folds one contribution per tile (rt=1), got rt={rt}")
        return kernels.repair_refold(pool_t, pool_c, r, d_fold=d_fold)
    return _refold_plain(pool_t, pool_c, r, rt, d_fold)


# ---------------- the repair ----------------


def repair_topk_bidir(
    ep,
    er,
    weights: CostWeights | None = None,
    *,
    fwd_p,
    fwd_c,
    pool_t,
    pool_c,
    dirty_p,
    dirty_t,
    reverse_r: int = 8,
    mesh: Mesh | None = None,
    tile: int = 1024,
    extra: int = 16,
):
    """Churn-masked repair of the persistent bidirectional candidate parts.

    Scope, derived from the stored parts as in the reference:

      forward rows R        = dirty tasks
                            ∪ rows listing a dirty provider in their top-k
                            ∪ rows a dirty provider's fresh cost can enter
                              (:func:`repair_enter` vs the stored k-th cost)
      reverse blocks (p, j) = all tiles of dirty providers
                            ∪ blocks whose contribution lists a dirty task
                            ∪ blocks a dirty task's fresh cost can enter
                              (:func:`tile_min` vs the block's worst kept
                              contribution)

    Rows in R and the flagged blocks are recomputed exactly; every other
    entry keeps its stored bits; the reverse edges are re-derived by
    replaying the fold over the pools, then merged. ``ep``/``er`` are the
    CURRENT columns on the repair's device; the parts are tensors (or
    arrays) of the cold pass's shapes and are not modified. With a
    ``mesh`` whose size divides T into whole tiles, the enter scan is
    sharded (:func:`repair_enter_sharded`) and the fold replays at D lanes,
    the parts of :func:`candidates_topk_bidir_sharded` at that D; else the
    repair runs at one device.
    ``dirty_p``/``dirty_t`` are global row ids. Returns ``(cand_p, cand_c,
    fwd_p, fwd_c, pool_t, pool_c, stats)`` as tensors on the columns'
    device, with the reference's scope counters (``repair_rows``,
    ``repair_providers``, ``repair_blocks``, ``repair_enter_rows``,
    ``visited_cells_frac``; no ``pad_hw``: there are no pad buckets).
    """
    if weights is None:
        weights = CostWeights()
    P, T = ep.num, er.num
    if T % tile != 0:
        raise ValueError(f"T={T} not divisible by tile={tile}")
    n_tiles = T // tile
    dev = ep.gpu_count.device
    fwd_p, fwd_c, pool_t, pool_c = (_as_part(a, dev) for a in (fwd_p, fwd_c, pool_t, pool_c))
    kk = fwd_p.shape[1]
    r = min(reverse_r, T)
    rt = max(1, -(-r // n_tiles))
    if pool_t.shape[1] != n_tiles * rt:
        raise ValueError(
            f"pool width {pool_t.shape[1]} != n_tiles*rt ({n_tiles}*{rt}) "
            f"for reverse_r={reverse_r}"
        )
    dirty_p = _as_ids(dirty_p, dev)
    dirty_t = _as_ids(dirty_t, dev)
    use_mesh = (
        mesh is not None and T % mesh.size == 0
        and (T // mesh.size) % tile == 0
    )

    # ---- forward scope
    rows = torch.zeros(T, dtype=torch.bool, device=dev)
    rows[dirty_t] = True
    enter_count = 0
    if dirty_p.numel():
        rows |= torch.isin(fwd_p, dirty_p.to(torch.int32)).any(dim=1)
        thresh = fwd_c[:, -1].contiguous()
        if use_mesh:
            enter = repair_enter_sharded(ep, er, weights, dirty_p, thresh, mesh).to(dev)
        else:
            enter = repair_enter(ep, er, weights, dirty_p, thresh)
        enter_count = int(enter.sum())
        rows |= enter
    R = torch.nonzero(rows).flatten()
    n_rows = R.numel()

    # ---- forward recompute
    if n_rows:
        new_p, new_c = forward_rows(ep, er, weights, kk, R)
        fwd_p = fwd_p.clone()
        fwd_c = fwd_c.clone()
        fwd_p[R] = new_p
        fwd_c[R] = new_c

    # ---- reverse scope: flag (provider, tile) contribution blocks
    flag = torch.zeros((P, n_tiles), dtype=torch.bool, device=dev)
    flag[dirty_p, :] = True
    if dirty_t.numel():
        pt3 = pool_t.reshape(P, n_tiles, rt)
        pc3 = pool_c.reshape(P, n_tiles, rt)
        flag |= torch.isin(pt3, dirty_t.to(torch.int32)).any(dim=2)
        min_dirty_tile = tile_min(ep, er, weights, torch.unique(dirty_t), tile)
        flag |= min_dirty_tile <= pc3[:, :, -1]
    blk_j, blk_p = torch.nonzero(flag.T, as_tuple=True)  # ordered by (tile, provider)
    blocks = blk_p.numel()
    pool_t = pool_t.clone()
    pool_c = pool_c.clone()
    if blocks:
        reverse_blocks(ep, er, weights, tile, rt, blk_p, blk_j, pool_t, pool_c)

    # ---- fold replay + merge (structure ops: bit-identical parts in,
    # bit-identical merged lists out)
    rev_t, rev_c = repair_refold(pool_t, pool_c, r, rt, mesh.size if use_mesh else 1)
    cand_p, cand_c = merge_reverse_candidates(fwd_p, fwd_c, rev_t, rev_c, extra=extra)
    visited = n_rows * P + blocks * tile + dirty_p.numel() * T
    stats = {
        "repair_rows": int(n_rows),
        "repair_providers": int(flag.any(dim=1).sum()),
        "repair_blocks": int(blocks),
        "repair_enter_rows": enter_count,
        "visited_cells_frac": round(visited / max(P * T, 1), 6),
    }
    return cand_p, cand_c, fwd_p, fwd_c, pool_t, pool_c, stats


# ---------------- sharded generation (B9 gen) ----------------


def candidates_topk_bidir_sharded(
    ep,
    er,
    weights: CostWeights | None = None,
    *,
    mesh: Mesh,
    k: int = 64,
    tile: int = 1024,
    reverse_r: int = 8,
    extra: int = 16,
    approx_recall: float | None = None,
    with_parts: bool = False,
):
    """Bidirectional candidates with the tasks sharded over ``mesh`` (the
    reference's ``candidates_topk_bidir_sharded``, body
    ``_build_sharded_gen``).

    Shard s owns task rows [s*Tl, (s+1)*Tl) and runs K1 over them at the
    jitter offset s*Tl, so each of its cells is the single-device pass's
    cell at the global id: the forward lists [Tl, k] and each tile's raw
    reverse pool [P, rt], with rt = ceil(r / n_tiles) over the GLOBAL tile
    count, folded into the shard's [P, r] from the (INFEASIBLE, -1) carry
    (a shard may hold fewer than r pool entries). The pools' and folds'
    task ids are made global, and the shards' folds meet in
    :func:`_merge_rev_pools` in shard order. Returns (cand_p [T, k+extra],
    cand_c); ``with_parts=True`` adds (fwd_p, fwd_c, pool_t, pool_c), the
    pools [P, n_tiles*rt] in global tile order. Every output lies on the
    mesh's first device."""
    _refuse_unported(approx_recall)
    if weights is None:
        weights = CostWeights()
    T = er.num
    D = mesh.size
    if T % D != 0:
        raise ValueError(f"T={T} not divisible by mesh size {D}; pad first")
    Tl = T // D
    if Tl % tile != 0:
        raise ValueError(f"local task count {Tl} not divisible by tile={tile}")
    k = min(k, ep.num)
    r = min(reverse_r, T)
    rt = max(1, -(-r // (T // tile)))  # per-tile pool contribution, global tiling
    fwd_p, fwd_c, rev_t, rev_c, pool_t, pool_c = ([] for _ in range(6))
    for s, dev in enumerate(mesh.devices):
        off = s * Tl
        ep_s = _on(ep, dev)
        er_s = _on(slice_requirements(er, off, Tl), dev)
        p, c, rt_s, rc_s, pt_s, pc_s = candidates_fused(ep_s, er_s, weights, k, tile, r, rt,
                                                        task_offset=off)
        fwd_p.append(p)
        fwd_c.append(c)
        # local task ids -> global; the carry's -1 stays
        rev_t.append(torch.where(rt_s >= 0, rt_s + off, rt_s)[None])
        rev_c.append(rc_s[None])
        pool_t.append(pt_s + off)
        pool_c.append(pc_s)
    fwd_p, fwd_c = all_gather(fwd_p, mesh), all_gather(fwd_c, mesh)
    merged_t, merged_c = _merge_rev_pools(all_gather(rev_c, mesh), all_gather(rev_t, mesh), r)
    cand_p, cand_c = merge_reverse_candidates(fwd_p, fwd_c, merged_t, merged_c, extra=extra)
    if with_parts:
        dev0 = mesh.devices[0]
        pool_t = torch.cat([t.to(dev0) for t in pool_t], dim=1)
        pool_c = torch.cat([t.to(dev0) for t in pool_c], dim=1)
        return cand_p, cand_c, fwd_p, fwd_c, pool_t, pool_c
    return cand_p, cand_c


# ---------------- the sharded auction (B9 phase) ----------------

_NO_BID = -(1 << 31)  # below every float's key


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 keys that a signed compare orders as the floats (the
    magnitude bits flipped when negative)."""
    b = x.view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


@dataclasses.dataclass
class _Shard:
    """One shard's part of a phase, on the shard's device: its rows'
    constants, its state (its replicas of price and owner, its rows'
    assignment and retirement, the control words) and a round's scratch.
    On a mesh of views of one device every field is a row of a tensor
    stacked over the shards (the same class with a leading [D] dimension),
    which the plain versions of K16 take whole."""

    offset: int
    cand_safe: torch.Tensor  # [Tl, K] i32
    value_base: torch.Tensor  # [Tl, K] f32
    feasible: torch.Tensor  # [Tl] u8
    give_up: torch.Tensor  # [1] f32
    price: torch.Tensor  # [P] f32, replica
    owner: torch.Tensor  # [P] i32 global task ids, replica
    p4t: torch.Tensor  # [Tl] i32
    retired: torch.Tensor  # [Tl] u8
    ctl: torch.Tensor  # [MESH_CTL] i32
    front: torch.Tensor  # [2 * B0] i32: frontier rows, then bidders' providers
    front_bid: torch.Tensor  # [B0] f32
    win_key: torch.Tensor  # [P] i32, _NO_BID between rounds
    win_task: torch.Tensor  # [P] i32, T between rounds


_SHARD_TENSORS = [f.name for f in dataclasses.fields(_Shard) if f.name != "offset"]


def _make_shards(mesh: Mesh, cand_p, cand_c, retire: bool, price, owner, p4t, retired, B: int):
    """The shards of one phase over the candidate arrays [T, K]: rows cut in
    shard order, price and owner replicated, give_up from the pmax of the
    shards' finite maxima (once a phase). Returns (shards, stacked): on a
    mesh of views of one device ``stacked`` holds every field over the
    shards and the shards' fields are its rows; else None."""
    T = cand_c.shape[0]
    P = price.shape[0]
    fields, local_max = [], []
    for s, (cp, cc, pt, rd) in enumerate(zip(
        shard_rows(cand_p, mesh), shard_rows(cand_c, mesh), shard_rows(p4t, mesh),
        shard_rows(retired, mesh),
    )):
        valid = cp >= 0
        dev = cc.device
        local_max.append(torch.where(valid, cc, 0.0).amax().reshape(1))
        feasible = valid.any(dim=1).to(torch.uint8)
        pt = pt.to(torch.int32).clone()
        rd = rd.to(torch.uint8).clone()
        ctl = torch.zeros(MESH_CTL, dtype=torch.int32, device=dev)
        ctl[CTL_OPEN] = ((pt < 0) & (feasible != 0) & (rd == 0)).sum()
        ctl[CTL_ASSIGNED] = (pt >= 0).sum()
        fields.append(dict(
            cand_safe=torch.where(valid, cp, 0).to(torch.int32), value_base=torch.where(valid, -cc, _NEG),
            feasible=feasible, p4t=pt, retired=rd, ctl=ctl,
            front=torch.zeros(2 * B, dtype=torch.int32, device=dev),
            front_bid=torch.zeros(B, dtype=torch.float32, device=dev),
            win_key=torch.full((P,), _NO_BID, dtype=torch.int32, device=dev),
            win_task=torch.full((P,), T, dtype=torch.int32, device=dev),
        ))
    for f, fm, pr, ow in zip(fields, pmax(local_max, mesh),
                             replicate(price.to(torch.float32), mesh),
                             replicate(owner.to(torch.int32), mesh)):
        f.update(give_up=-(2.0 * fm + 10.0) if retire else torch.full_like(fm, _NEG),
                 price=pr, owner=ow)
    Tl = T // mesh.size
    if len(set(mesh.devices)) > 1:
        return [_Shard(offset=s * Tl, **f) for s, f in enumerate(fields)], None
    stacked = _Shard(offset=0, **{n: torch.stack([f[n] for f in fields]) for n in _SHARD_TENSORS})
    shards = [
        _Shard(offset=s * Tl, **{n: getattr(stacked, n)[s] for n in _SHARD_TENSORS})
        for s in range(mesh.size)
    ]
    return shards, stacked


# ---- plain versions of K16's three steps, over every shard of a mesh of
# views of one device at once (the fields of the stacked _Shard)


def _round_bid_plain(st: _Shard, tot, eps: float, B: int, max_iters: int,
                     stall_limit: int) -> None:
    """Plain torch version of K16's bid step on every shard (in place);
    ``tot`` [D, 2] the combined counts each shard holds."""
    D, Tl, K = st.value_base.shape
    P = st.price.shape[1]
    dev = st.ctl.device
    ctl = st.ctl.tolist()
    go = []
    for c, (n_open, n_now) in zip(ctl, tot.tolist()):
        if c[CTL_PENDING]:
            c[CTL_STALL] = 0 if n_now > c[CTL_BEST] else c[CTL_STALL] + 1
            c[CTL_BEST] = max(c[CTL_BEST], n_now)
            c[CTL_IT] += 1
        c[CTL_GO] = c[CTL_PENDING] = int(
            c[CTL_IT] < max_iters and n_open > 0 and (stall_limit <= 0 or c[CTL_STALL] < stall_limit)
        )
        c[CTL_NB] = 0
        go.append(bool(c[CTL_GO]))
    if any(go):
        go_t = torch.tensor(go, device=dev)
        tl = torch.arange(Tl, dtype=torch.int32, device=dev)
        open_mask = (st.p4t < 0) & st.feasible.bool() & ~st.retired.bool() & go_t[:, None]
        f_idx = torch.sort(torch.where(open_mask, tl, Tl), dim=1).values[:, :B]  # [D, B]
        f_ok = f_idx < Tl
        # every shard's rows and prices at once: shard d's rows at d * Tl,
        # its price replica at d * P
        row0 = (torch.arange(D, device=dev) * Tl)[:, None]
        p0 = (torch.arange(D, device=dev) * P)[:, None, None]
        p1, v1, v2 = frontier_bids(
            (st.cand_safe + p0).reshape(D * Tl, K), st.value_base.reshape(D * Tl, K),
            st.price.reshape(D * P), (row0 + f_idx).reshape(-1), f_ok.reshape(-1), K,
        )
        p1, v1, v2 = p1.reshape(D, B), v1.reshape(D, B), v2.reshape(D, B)
        newly_retired = f_ok & (v1 < st.give_up)
        st.retired.view(-1)[(row0 + f_idx)[newly_retired]] = 1
        bidding = f_ok & ~newly_retired & (v1 > _NEG * 0.5)
        bid = st.price.view(-1)[p1] + (v1 - v2) + eps
        st.win_key.view(-1).scatter_reduce_(0, p1[bidding], _ordered_key(bid[bidding]), "amax")
        front = st.front[:, :2 * B].view(D, 2, B)
        front[:, 0] = f_idx
        front[:, 1] = torch.where(bidding, p1 - p0[:, :, 0], -1)
        st.front_bid[:, :B] = bid
        nb = f_ok.sum(dim=1).tolist()
        retired_n = newly_retired.sum(dim=1).tolist()
        for c, n, r_ in zip(ctl, nb, retired_n):
            c[CTL_NB] = n
            c[CTL_ROWS] += n
            c[CTL_OPEN] -= r_
    st.ctl.copy_(torch.tensor(ctl, dtype=torch.int32))


def _round_resolve_plain(st: _Shard, win_key, B: int) -> None:
    """Plain torch version of K16's resolve step on every shard (in place);
    ``win_key`` [D, P] the combined keys each shard holds."""
    D, P = st.win_task.shape
    dev = st.ctl.device
    front = st.front[:, :2 * B].view(D, 2, B)
    nb = st.ctl[:, CTL_NB]
    p = front[:, 1]
    bidder = (torch.arange(B, device=dev)[None, :] < nb[:, None]) & (p >= 0)
    p_safe = torch.where(bidder, p, 0)
    won = bidder & (st.front_bid[:, :B] >= _from_key(win_key.gather(1, p_safe.long())))
    Tl = st.p4t.shape[1]
    d = torch.arange(D, dtype=torch.int32, device=dev)[:, None]
    gtask = d * Tl + front[:, 0]  # offset + row
    st.win_task.view(-1).scatter_reduce_(0, (d * P + p_safe)[won].long(), gtask[won], "amin")


def _round_apply_plain(st: _Shard, win_key, win_task, T: int) -> None:
    """Plain torch version of K16's apply step on every shard (in place);
    ``win_key`` / ``win_task`` [D, P] the combined arrays each shard holds."""
    D, Tl = st.p4t.shape
    P = st.price.shape[1]
    dev = st.ctl.device
    go = st.ctl[:, CTL_GO].bool()
    st.win_key[go] = _NO_BID
    st.win_task[go] = T
    win_bid = _from_key(win_key)  # NaN where no bid: never > _NEG / 2
    d, p = torch.nonzero(go[:, None] & (win_bid > _NEG * 0.5) & (win_task < T), as_tuple=True)
    wb, wt, old = win_bid[d, p], win_task[d, p], st.owner[d, p]
    lo = d.to(torch.int32) * Tl  # each shard's offset
    ev = (old >= lo) & (old < lo + Tl)
    e = (d * Tl + (old - lo))[ev]  # into the stacked rows
    seated = st.p4t.view(-1)[e] >= 0
    feas, ret, p4t = st.feasible.view(-1), st.retired.view(-1), st.p4t.view(-1)
    d_open = torch.bincount(d[ev][seated & feas[e].bool() & ~ret[e].bool()], minlength=D)
    d_assigned = -torch.bincount(d[ev][seated], minlength=D)
    p4t[e] = -1
    wins = (wt >= lo) & (wt < lo + Tl)
    w = (d * Tl + (wt - lo))[wins]
    free = p4t[w] < 0
    d_open -= torch.bincount(d[wins][free & feas[w].bool() & ~ret[w].bool()], minlength=D)
    d_assigned += torch.bincount(d[wins][free], minlength=D)
    p4t[w] = p[wins].to(torch.int32)
    st.owner[d, p] = wt
    st.price[d, p] = wb
    st.ctl[:, CTL_OPEN] += d_open.to(torch.int32)
    st.ctl[:, CTL_ASSIGNED] += d_assigned.to(torch.int32)


# ---- the phase: rounds in segments


def segment_route(devices, Tl: int, K: int, B: int) -> str:
    """How ``_segment`` runs the rounds of a mesh over ``devices`` (one a
    shard) with Tl rows a shard, K candidates a row and a per-shard
    frontier of B, from the devices and the shapes alone: ``"plain"`` (the
    plain rounds over the stacked shards) off a card; ``"segment"``, K16's
    segment launch (every shard's rounds in one cluster launch per
    :data:`CARD_CHECK_EVERY` rounds), where every shard lies on one card
    and the shapes fit it; else ``"rounds"``, three launches a shard a
    round around the host's pmax and pmin (shards on several cards)."""
    from protocol_tpu_torch import kernels

    if devices[0].type != "cuda":
        return "plain"
    if len(set(devices)) == 1 and kernels.mesh_segment_fits(len(devices), Tl, K, B):
        return "segment"
    return "rounds"


def _segment(mesh: Mesh, shards: list, stacked, T: int, eps: float, B: int, max_iters: int,
             stall_limit: int, route: str | None = None) -> tuple[int, int, int]:
    """Up to ``max_iters`` rounds of the sharded phase from the shards'
    state (a run of the reference's ``_build_sharded_phase``: it, best and
    stall start afresh), by ``route`` (default :func:`segment_route`'s;
    ``"plain"`` on a card is its check of K16). A round: each shard's bid
    step, pmax of the bid keys, each shard's resolve step, pmin of the
    winners, each shard's apply step, psum of the counts. On the
    ``"rounds"`` route the steps are K16's launches per shard, on
    ``"segment"`` one launch runs every shard's rounds, 256 at a time; the
    plain versions run over the stacked shards. The stop is decided on the
    device, so a card runs the rounds without a read-back but one a
    segment launch or every 256 rounds. Returns (it, stall, open tasks) at
    the end."""
    if route is None:
        route = segment_route(mesh.devices, *shards[0].value_base.shape, B)
    if route != "rounds" and stacked is None:
        raise ValueError(f"the {route} route takes a mesh of views of one device")
    if route == "segment":
        return _segment_launches(stacked, eps, B, max_iters, stall_limit)
    on_card = route == "rounds"
    tot = psum([sh.ctl[CTL_OPEN:] for sh in shards], mesh)
    for sh, t in zip(shards, tot):
        sh.ctl[:CTL_OPEN] = 0
        sh.ctl[CTL_BEST] = t[1]
    if on_card:
        from protocol_tpu_torch import kernels

    def bid():
        if on_card:
            for sh, t in zip(shards, tot):
                f = sh.front[:2 * B]
                kernels.mesh_round_bid(sh.cand_safe, sh.value_base, sh.feasible, sh.give_up,
                                       sh.price, sh.retired, sh.p4t, t, sh.ctl, f,
                                       sh.front_bid[:B], sh.win_key, eps, B, max_iters,
                                       stall_limit)
        else:
            _round_bid_plain(stacked, torch.stack(tot), eps, B, max_iters, stall_limit)

    check = CARD_CHECK_EVERY if on_card else 1
    for rnd in range(max_iters):
        bid()
        if (rnd + 1) % check == 0 and rnd + 1 < max_iters and not int(shards[0].ctl[CTL_GO]):
            break  # stopped: later rounds do nothing, and nothing is pending
        keys = pmax([sh.win_key for sh in shards], mesh)
        if on_card:
            for sh, k in zip(shards, keys):
                kernels.mesh_round_resolve(sh.ctl, sh.front[:2 * B], sh.front_bid[:B], k,
                                           sh.win_task, sh.offset)
        else:
            _round_resolve_plain(stacked, torch.stack(keys), B)
        tasks = pmin([sh.win_task for sh in shards], mesh)
        if on_card:
            for sh, k, w in zip(shards, keys, tasks):
                kernels.mesh_round_apply(k, w, sh.feasible, sh.retired, sh.ctl, sh.price,
                                         sh.owner, sh.p4t, sh.win_key, sh.win_task, sh.offset, T)
        else:
            _round_apply_plain(stacked, torch.stack(keys), torch.stack(tasks), T)
        tot = psum([sh.ctl[CTL_OPEN:] for sh in shards], mesh)
    else:
        bid()  # folds the last round's counts into the state
    it, stall, open_count = torch.cat([shards[0].ctl[[CTL_IT, CTL_STALL]], tot[0][:1]]).tolist()
    return it, stall, open_count


def _segment_launches(st: _Shard, eps: float, B: int, max_iters: int,
                      stall_limit: int) -> tuple[int, int, int]:
    """``_segment``'s rounds as K16's segment launches over the stacked
    shards ``st``: a launch runs up to CARD_CHECK_EVERY rounds, the first
    from a fresh loop state, each next one from the state the last left in
    ``ctl``, until its go word is 0 (one read-back a launch)."""
    from protocol_tpu_torch import kernels

    fresh = True
    while True:
        kernels.mesh_segment(st.cand_safe, st.value_base, st.feasible, st.give_up, st.price,
                             st.owner, st.p4t, st.retired, st.ctl, eps, B, max_iters,
                             stall_limit, fresh)
        fresh = False
        ctl = st.ctl.tolist()
        if not ctl[0][CTL_GO]:
            return ctl[0][CTL_IT], ctl[0][CTL_STALL], sum(c[CTL_OPEN] for c in ctl)


def _run_phase_sharded(mesh: Mesh, P: int, B0: int, max_iters: int, cand_p, cand_c, eps: float,
                       stall_limit: int, price, owner, p4t, frontier_ladder: bool,
                       retired=None, retire: bool = True):
    """One sharded eps phase from carried (price, owner, p4t, retired):
    at once (``max_iters`` rounds, the stall limit on the device), or with
    ``frontier_ladder`` in 256-round segments with the per-shard frontier
    refit to the live open set between them (floor max(64, 512 // D)) and
    the stall carried across them, as the reference's
    ``_run_phase_sharded``. The rounds' route is :func:`segment_route`'s,
    decided once a phase at the first frontier. Returns (price, owner, p4t,
    retired, stall) on the mesh's first device."""
    D = mesh.size
    T = cand_c.shape[0]
    if retired is None:
        retired = torch.zeros(T, dtype=torch.bool, device=cand_c.device)
    shards, stacked = _make_shards(mesh, cand_p, cand_c, retire, price, owner, p4t, retired, B0)
    route = segment_route(mesh.devices, T // D, cand_c.shape[1], B0)
    if not frontier_ladder:
        _, stall, _ = _segment(mesh, shards, stacked, T, eps, B0, max_iters, stall_limit, route)
    else:
        seg_rounds = 256
        iters_left = max_iters
        B = B0
        stall = 0
        floor = max(64, 512 // D)
        while iters_left > 0:
            _, s, open_count = _segment(mesh, shards, stacked, T, eps, B, seg_rounds, 0, route)
            # a segment reports its own trailing stall; a whole-segment
            # stall accumulates
            stall = stall + seg_rounds if s >= seg_rounds else s
            iters_left -= seg_rounds
            if open_count == 0:
                break
            if stall_limit > 0 and stall >= stall_limit:
                break
            fit = floor
            while fit * D < open_count and fit < B:
                fit *= 2
            B = min(B, fit)
    return (
        shards[0].price, shards[0].owner,
        all_gather([sh.p4t for sh in shards], mesh),
        all_gather([sh.retired for sh in shards], mesh).bool(),
        stall,
    )


def _mesh_rows(T: int, mesh: Mesh) -> int:
    D = mesh.size
    if T % D != 0:
        raise ValueError(f"T={T} not divisible by mesh size {D}; pad first")
    return T // D


def assign_auction_sparse_sharded(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    mesh: Mesh,
    eps: float = 0.01,
    max_iters: int = 10000,
    frontier: int = 4096,
    retire: bool = True,
) -> AssignResult:
    """The sparse auction with the tasks sharded over ``mesh``, one phase
    from zero duals (T divisible by the mesh size). With frontier >= T/D
    and ``retire=False`` it is the Jacobi schedule, equal to the
    single-device auction's."""
    T = cand_cost.shape[0]
    B = min(frontier, _mesh_rows(T, mesh))
    dev = mesh.devices[0]
    cand_provider, cand_cost = cand_provider.to(dev), cand_cost.to(dev)
    _price, _owner, p4t, _retired, _stall = _run_phase_sharded(
        mesh, num_providers, B, int(max_iters), cand_provider, cand_cost, eps, 0,
        torch.zeros(num_providers, dtype=torch.float32, device=dev),
        torch.full((num_providers,), -1, dtype=torch.int32, device=dev),
        torch.full((T,), -1, dtype=torch.int32, device=dev), False, retire=retire,
    )
    return AssignResult(p4t, _invert(p4t, num_providers))


def assign_auction_sparse_scaled_sharded(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    mesh: Mesh,
    eps_start: float = 4.0,
    eps_end: float = 0.02,
    scale: float = 0.25,
    max_iters_per_phase: int = 4000,
    frontier: int = 4096,
    with_prices: bool = False,
    stall_limit: int = 64,
    stats_out: dict | None = None,
    frontier_ladder: bool = False,
    with_state: bool = False,
):
    """The eps-scaling ladder over the sharded phase, with the single-device
    ladder's discipline: coarse phases whose retirements are dropped, the
    eps-CS repair between rungs, a binding final phase with 8x the stall
    budget, the greedy cleanup (K9) at the end; the repair and the cleanup
    run on the gathered arrays on the mesh's first device."""
    T = cand_cost.shape[0]
    B = min(frontier, _mesh_rows(T, mesh))
    dev = mesh.devices[0]
    cand_provider, cand_cost = cand_provider.to(dev), cand_cost.to(dev)
    price = torch.zeros(num_providers, dtype=torch.float32, device=dev)
    owner = torch.full((num_providers,), -1, dtype=torch.int32, device=dev)
    p4t = torch.full((T,), -1, dtype=torch.int32, device=dev)
    eps = eps_start
    while True:
        final = eps <= eps_end
        price, owner, p4t, retired, stall = _run_phase_sharded(
            mesh, num_providers, B, max_iters_per_phase, cand_provider, cand_cost, eps,
            stall_limit * (8 if final else 1), price, owner, p4t, frontier_ladder,
        )
        if final:
            _report_stall("scaled-sharded", stall, stall_limit * 8, stats_out)
            break
        eps = max(eps * scale, eps_end)
        # each phase starts from a fresh retirement mask: only the binding
        # phase's retirement survives
        owner, p4t = _unassign_unhappy(cand_provider, cand_cost, price, owner, p4t, eps)
    p4t = _greedy_cleanup(cand_provider, cand_cost, owner, p4t)
    res = AssignResult(p4t, _invert(p4t, num_providers))
    if with_state:
        return res, price, retired & (p4t < 0)
    if with_prices:
        return res, price
    return res


def assign_auction_sparse_warm_sharded(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    mesh: Mesh,
    price0: torch.Tensor,
    p4t0: torch.Tensor,
    eps: float = 0.02,
    max_iters: int = 20000,
    frontier: int = 4096,
    stall_limit: int = 64,
    stats_out: dict | None = None,
    frontier_ladder: bool = False,
    retired0: torch.Tensor | None = None,
    with_state: bool = False,
):
    """The delta-frontier auction from carried duals over the mesh, with
    the single-device warm solve's seed hygiene (candidate-less seeds
    dropped, prices shifted down to finite_max + 5, eps-CS evictions), one
    binding sharded phase and the greedy cleanup. Returns (AssignResult,
    prices), plus the retirement mask with ``with_state=True``."""
    T = cand_cost.shape[0]
    B = min(frontier, _mesh_rows(T, mesh))
    dev = mesh.devices[0]
    cand_provider, cand_cost = cand_provider.to(dev), cand_cost.to(dev)
    task_has_cand = (cand_provider >= 0).any(dim=1)
    p4t0 = torch.where(task_has_cand, p4t0.to(dev, torch.int32), -1)
    finite_max = torch.where(cand_provider >= 0, cand_cost, 0.0).amax()
    price0 = price0.to(dev, torch.float32)
    price0 = price0 - torch.clamp(price0.amax() - (finite_max + 5.0), min=0.0)
    owner0 = _invert(p4t0, num_providers)
    owner0, p4t0 = _unassign_unhappy(cand_provider, cand_cost, price0, owner0, p4t0, eps)
    if retired0 is None:
        retired_seed = torch.zeros(T, dtype=torch.bool, device=dev)
    else:
        retired_seed = retired0.to(dev, torch.bool) & (p4t0 < 0)
    price, owner, p4t, retired, stall = _run_phase_sharded(
        mesh, num_providers, B, max_iters, cand_provider, cand_cost, eps, stall_limit * 8,
        price0, owner0, p4t0, frontier_ladder, retired=retired_seed,
    )
    _report_stall("warm-sharded", stall, stall_limit * 8, stats_out)
    p4t = _greedy_cleanup(cand_provider, cand_cost, owner, p4t)
    res = AssignResult(p4t, _invert(p4t, num_providers))
    if with_state:
        return res, price, retired & (p4t < 0)
    return res, price
