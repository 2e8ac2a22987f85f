"""Churn-masked repair of the persistent candidate structure
(``protocol_tpu/parallel/sparse.py``), at one device.

  repair_topk_bidir
        the single-device form of the reference's
        ``repair_topk_bidir_sharded``: patches the generation parts (forward
        lists [T, k] and per-tile reverse pools [P, n_tiles*rt]) for the
        dirty provider and task rows, replays the reverse fold over the
        pools and re-merges. The result is bit-identical to a from-scratch
        :func:`~protocol_tpu_torch.ops.sparse.candidates_topk_reverse` pass
        plus merge on the current columns (the repaired == regen contract).

Five functions hold hand kernels for Hopper (``csrc/``); each dispatches on
the device of its inputs, with no fallback: a CPU tensor takes the plain
torch version beside it, a CUDA tensor the kernel.

  repair_enter     -> K3 (``csrc/repair.cu``), the reference's
                      ``_build_repair_enter``
  forward_rows     -> K1's forward launch (``csrc/candidates.cu``),
                      the selection of ``_build_repair_forward``
  tile_min         -> K4 (``csrc/repair.cu``), the dirty-column cost block
                      of ``_build_repair_forward`` reduced to per-(provider,
                      tile) minima
  reverse_blocks   -> K1 reverse, blocks variant (``csrc/candidates.cu``),
                      ``_build_repair_tile``
  repair_refold    -> K5 (``csrc/repair.cu``), ``_build_repair_refold`` +
                      ``_merge_rev_pools``

Every cell is scored with its global provider and task ids in the tie
jitter, so a recomputed subset lands on the exact cells of the full pass.
The reference pads every gather to a pow-2 bucket (``_pow2_pad``,
``_gather_rows``, ``pad_floors``) only to bound JAX retraces; here each
gather takes exactly the rows it needs. The mesh branch is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix, tie_jitter_ids
from protocol_tpu_torch.ops.encoding import (
    gather_providers,
    gather_requirements,
    slice_requirements,
)
from protocol_tpu_torch.ops.sparse import _smallest_stable, merge_reverse_candidates

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


def _enter_plain(ep, er, weights, p_ids, thresh):
    """Plain torch version of K3: enter [T] bool."""
    T = er.num
    dev = thresh.device
    ep_d = gather_providers(ep, p_ids)
    enter = torch.zeros(T, dtype=torch.bool, device=dev)
    for t0 in range(0, T, _CHUNK):
        n = min(_CHUNK, T - t0)
        t_ids = torch.arange(t0, t0 + n, device=dev)
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


def _merge_rev_pools(rev_c_all, rev_t_all, r: int):
    """Best r of the D per-lane [P, r] fold results (stable), -1 where the
    cost is >= INFEASIBLE/2: (rev_t [P, r], rev_c). At D = 1 a stable top-r
    of r sorted entries, so only the mask acts."""
    D, P, _ = rev_c_all.shape
    rev_c_cat = rev_c_all.movedim(0, 1).reshape(P, D * r)
    rev_t_cat = rev_t_all.movedim(0, 1).reshape(P, D * r)
    m = _smallest_stable(rev_c_cat, r)
    rev_c = torch.gather(rev_c_cat, 1, m)
    rev_t = torch.gather(rev_t_cat, 1, m)
    return torch.where(rev_c < INFEASIBLE * 0.5, rev_t, -1), rev_c


def _refold_plain(pool_t, pool_c, r: int, rt: int):
    """Plain torch version of K5: the generation fold replayed over the
    pools in tile order (stable top-r of carry then tile, the carry
    first), then the one-lane merge."""
    P = pool_c.shape[0]
    n_tiles = pool_c.shape[1] // rt
    rev_c = torch.full((P, r), INFEASIBLE, dtype=torch.float32, device=pool_c.device)
    rev_t = torch.full((P, r), -1, dtype=torch.int32, device=pool_c.device)
    for j in range(n_tiles):
        merged_c = torch.cat([rev_c, pool_c[:, j * rt:(j + 1) * rt]], dim=1)
        merged_t = torch.cat([rev_t, pool_t[:, j * rt:(j + 1) * rt]], dim=1)
        m = _smallest_stable(merged_c, r)
        rev_c = torch.gather(merged_c, 1, m)
        rev_t = torch.gather(merged_t, 1, m)
    return _merge_rev_pools(rev_c[None], rev_t[None], r)


# ---------------- dispatch: kernel on a card, plain version on the CPU ----


def repair_enter(ep, er, weights, p_ids, thresh):
    """Tasks a dirty provider (global ids ``p_ids``) can enter: some fresh
    feasible jittered cost <= the task's stored k-th cost ``thresh`` [T]
    (``<=`` over-flags exact ties on purpose). Returns [T] bool."""
    if thresh.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.repair_enter(ep, er, weights, p_ids, thresh)
    return _enter_plain(ep, er, weights, p_ids, thresh)


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


def repair_refold(pool_t, pool_c, r: int, rt: int):
    """Reverse edges from the pools: (rev_t [P, r] with -1 padding, rev_c)."""
    if pool_c.is_cuda:
        from protocol_tpu_torch import kernels

        if rt != 1:
            raise ValueError(f"K5 folds one contribution per tile (rt=1), got rt={rt}")
        return kernels.repair_refold(pool_t, pool_c, r)
    return _refold_plain(pool_t, pool_c, r, rt)


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
    arrays) of the cold pass's shapes and are not modified.
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

    # ---- forward scope
    rows = torch.zeros(T, dtype=torch.bool, device=dev)
    rows[dirty_t] = True
    enter_count = 0
    if dirty_p.numel():
        rows |= torch.isin(fwd_p, dirty_p.to(torch.int32)).any(dim=1)
        enter = repair_enter(ep, er, weights, dirty_p, fwd_c[:, -1].contiguous())
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
    rev_t, rev_c = repair_refold(pool_t, pool_c, r, rt)
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
