"""The provider-sharded dense auction (``protocol_tpu/parallel/auction.py``).

The cost rows (providers) are cut over the mesh in shard order: each
shard owns the value rows of its Pl providers, value_base [T, Pl] (the
only O(P T) object), and its providers' prices and owners. The
assignment p4t [T] and the loop state live once, on the mesh's first
device, and every shard reads a copy. A round (the reference's
while_loop body):

  scan      each shard's best value v1 at the first maximum, runner-up v2
            (only the best masked), best provider (global id) and its
            price, for every open task;
  combine   the shards' four [T] arrays gathered onto the first device:
            the best shard is the first maximum of v1 (equal values go to
            the lower shard, the lower provider ids), gv2 = max(the other
            shards' v1, every shard's v2) floored at -1e8, and an open
            task with gv1 > -5e17 bids (price1 + (gv1 - gv2)) + eps;
  resolve   each shard's providers take their highest bid, ties to the
            lowest task; the winner evicts the owner and sets the price;
            the shard writes its [T] delta (-2 no change, -1 evicted, the
            global provider id for a win);
  finish    the pmax of the deltas updates p4t; the round count and the
            open tasks decide the next round (it < max_iters and a
            feasible task open).

The result equals the one-device dense auction (``ops/assign.py::
assign_auction``, K7) bit for bit: the tie-breaking is the same.

On a CUDA tensor the steps are kernel K17 (``csrc/mesh_dense.cu``): a
scan, a resolve and an apply launch per shard, a combine and a finish
launch on the first device, every launch a no-op once the loop state on
the device says stop, so the host enqueues 256-round segments with one
read-back each. On a CPU tensor, or anywhere with ``plain``, the plain
versions ``_round_*_plain`` run every shard at once over stacked views
of one device.
"""

from __future__ import annotations

import dataclasses

import torch

from protocol_tpu_torch.kernels import (
    CARD_CHECK_EVERY, DCTL_GO, DCTL_IT, DCTL_OPEN, DCTL_ROWS, DENSE_CTL,
)
from protocol_tpu_torch.ops.assign import _NEG, AssignResult, _invert
from protocol_tpu_torch.ops.cost import INFEASIBLE
from protocol_tpu_torch.parallel.mesh import Mesh, all_gather, broadcast, psum, shard_rows

@dataclasses.dataclass
class _DenseShard:
    """One shard's part of the auction, on the shard's device. On a mesh of
    views of one device every field is a row of a tensor stacked over the
    shards (the same class with a leading [D] dimension), which the plain
    rounds take whole."""

    offset: int
    value_base: torch.Tensor  # [T, Pl] f32
    price: torch.Tensor  # [Pl] f32
    owner: torch.Tensor  # [Pl] i32, global task ids
    win_key: torch.Tensor  # [Pl] i64 bits of (bid key << 32 | ~task), 0 between rounds
    scan: torch.Tensor  # [4, T] f32: v1, v2, global p1 (int32 bits), price1
    delta: torch.Tensor  # [T] i32


_FIELDS = [f.name for f in dataclasses.fields(_DenseShard) if f.name != "offset"]


def _make_shards(mesh: Mesh, cost: torch.Tensor):
    """The shards over the cost rows [P, T]: each shard's value rows
    where(cost < INFEASIBLE/2, -cost, -1e18).T and fresh state. Returns
    (shards, stacked, task_feasible [T] bool on the first device, from the
    psum of the shards' any); ``stacked`` holds every field over the
    shards on a mesh of views of one device, else None."""
    P, T = cost.shape
    D = mesh.size
    Pl = P // D
    one_device = len(set(mesh.devices)) == 1

    def fields(dev, lead=()):
        return dict(
            value_base=torch.empty((*lead, T, Pl), dtype=torch.float32, device=dev),
            price=torch.zeros((*lead, Pl), dtype=torch.float32, device=dev),
            owner=torch.full((*lead, Pl), -1, dtype=torch.int32, device=dev),
            win_key=torch.zeros((*lead, Pl), dtype=torch.int64, device=dev),
            scan=torch.zeros((*lead, 4, T), dtype=torch.float32, device=dev),
            delta=torch.full((*lead, T), -2, dtype=torch.int32, device=dev),
        )

    if one_device:
        stacked = _DenseShard(offset=0, **fields(mesh.devices[0], (D,)))
        shards = [_DenseShard(offset=s * Pl, **{n: getattr(stacked, n)[s] for n in _FIELDS})
                  for s in range(D)]
    else:
        stacked = None
        shards = [_DenseShard(offset=s * Pl, **fields(d)) for s, d in enumerate(mesh.devices)]
    feas = []
    for sh, c in zip(shards, shard_rows(cost, mesh)):
        # value rows per task, as ops/assign.py::_value_base builds them
        sh.value_base.copy_(torch.where(c < INFEASIBLE * 0.5, -c, _NEG).T)
        feas.append((sh.value_base > _NEG * 0.5).any(dim=1).to(torch.int32))
    return shards, stacked, psum(feas, mesh)[0] > 0


# ---- plain versions of K17's steps, over every shard of a mesh of views of
# one device at once (the fields of the stacked _DenseShard)


def _round_scan_plain(st: _DenseShard, p4t, feasible) -> None:
    """K17's scan on every shard (in place)."""
    D, T, Pl = st.value_base.shape
    dev = p4t.device
    st.delta.fill_(-2)
    rows = torch.nonzero((p4t < 0) & feasible).flatten()
    value = st.value_base[:, rows, :] - st.price[:, None, :]  # [D, R, Pl]
    p1 = torch.argmax(value, dim=2)  # the first maximum: the lowest local index
    v1 = torch.gather(value, 2, p1[..., None])[..., 0]
    v2 = torch.where(torch.arange(Pl, device=dev) == p1[..., None], _NEG, value).amax(dim=2)
    offset = (torch.arange(D, device=dev) * Pl)[:, None]
    st.scan[:, 0, rows] = v1
    st.scan[:, 1, rows] = v2
    st.scan.view(torch.int32)[:, 2, rows] = torch.where(v1 > _NEG * 0.5, offset + p1,
                                                        -1).to(torch.int32)
    st.scan[:, 3, rows] = torch.gather(st.price, 1, p1)


def _round_combine_plain(gathered, p4t, feasible, eps: float, bt) -> None:
    """K17's combine (in place into ``bt`` [2, T]) from ``gathered`` [D, 4, T]."""
    D = gathered.shape[0]
    av1, av2, apr = gathered[:, 0], gathered[:, 1], gathered[:, 3]
    ap1 = gathered.view(torch.int32)[:, 2]
    best = torch.argmax(av1, dim=0)[None, :]  # the first maximum: the lower shard
    gv1 = torch.gather(av1, 0, best)[0]
    masked = torch.where(torch.arange(D, device=av1.device)[:, None] == best, _NEG, av1)
    gv2 = torch.clamp(torch.maximum(masked.amax(dim=0), av2.amax(dim=0)), min=-1e8)
    eps32 = torch.tensor(eps, dtype=torch.float32, device=av1.device)
    bt[0] = torch.gather(apr, 0, best)[0] + (gv1 - gv2) + eps32
    bidding = (p4t < 0) & feasible & (gv1 > _NEG * 0.5)
    bt.view(torch.int32)[1] = torch.where(bidding, torch.gather(ap1, 0, best)[0], -1)


def _round_resolve_apply_plain(st: _DenseShard, bt) -> None:
    """K17's resolve and apply on every shard (in place): per provider the
    highest bid, ties to the lowest task, evicts the owner and seats the
    winner. Stacked, the flat provider index is the global id."""
    D, T, Pl = st.value_base.shape
    dev = bt.device
    bid, tgt = bt[0], bt.view(torch.int32)[1]
    bidder = torch.nonzero(tgt >= 0).flatten()
    g = tgt[bidder].long()
    win_bid = torch.full((D * Pl,), -torch.inf, dtype=torch.float32, device=dev)
    win_bid = win_bid.scatter_reduce(0, g, bid[bidder], "amax")
    top = bid[bidder] == win_bid[g]
    win_t = torch.full((D * Pl,), T, dtype=torch.int64, device=dev)
    win_t = win_t.scatter_reduce(0, g[top], bidder[top], "amin")
    got = torch.nonzero((win_t < T) & (win_bid > _NEG * 0.5)).flatten()
    owner, price = st.owner.view(-1), st.price.view(-1)
    shard = got // Pl
    old = owner[got]
    ev = old >= 0
    st.delta[shard[ev], old[ev].long()] = -1
    st.delta[shard, win_t[got]] = got.to(torch.int32)
    owner[got] = win_t[got].to(torch.int32)
    price[got] = win_bid[got]


def _round_finish_plain(deltas, feasible, ctl, p4t, max_iters: int) -> None:
    """K17's finish (in place): the pmax of ``deltas`` [D, T] into p4t, then
    the loop state."""
    gdelta = deltas.amax(dim=0)
    p4t.copy_(torch.where(gdelta > -2, gdelta, p4t))
    n_open = ((p4t < 0) & feasible).sum()
    ctl[DCTL_ROWS] += ctl[DCTL_OPEN]
    ctl[DCTL_IT] += 1
    ctl[DCTL_OPEN] = n_open
    ctl[DCTL_GO] = ((ctl[DCTL_IT] < max_iters) & (n_open > 0)).to(torch.int64)


def _rounds(mesh: Mesh, shards: list, stacked, task_feasible, eps: float, max_iters: int,
            plain: bool = False):
    """The auction's rounds from fresh duals over the shards: K17's launches
    on a card, reading the go flag back every CARD_CHECK_EVERY rounds; the
    plain rounds over the stacked shards on the CPU, or anywhere with
    ``plain`` (the card's check of K17), reading it every round. Returns
    (p4t [T] i32 on the first device, the loop state ctl [DENSE_CTL] i64:
    rounds, go, open tasks, open rows summed over the rounds)."""
    dev0 = mesh.devices[0]
    T = task_feasible.shape[0]
    on_card = task_feasible.is_cuda and not plain
    if not on_card and stacked is None:
        raise ValueError("the plain rounds take a mesh of views of one device")
    feasible = task_feasible.to(dev0)
    p4t = torch.full((T,), -1, dtype=torch.int32, device=dev0)
    ctl = torch.zeros(DENSE_CTL, dtype=torch.int64, device=dev0)
    ctl[DCTL_OPEN] = feasible.sum()
    ctl[DCTL_GO] = ((ctl[DCTL_OPEN] > 0) & (max_iters > 0)).to(torch.int64)
    bt = torch.empty((2, T), dtype=torch.float32, device=dev0)  # bids, targets
    if on_card:
        from protocol_tpu_torch import kernels

        feas_u8 = feasible.to(torch.uint8)
        feas_parts = broadcast(feas_u8, mesh)
    check = CARD_CHECK_EVERY if on_card else 1
    for rnd in range(max_iters):
        if rnd % check == 0 and not int(ctl[DCTL_GO]):
            break  # stopped: later rounds do nothing
        if not on_card:
            _round_scan_plain(stacked, p4t, feasible)
            _round_combine_plain(stacked.scan, p4t, feasible, eps, bt)
            _round_resolve_apply_plain(stacked, bt)
            _round_finish_plain(stacked.delta, feasible, ctl, p4t, max_iters)
            continue
        p4t_parts, ctl_parts = broadcast(p4t, mesh), broadcast(ctl, mesh)
        for sh, pt, fe, c in zip(shards, p4t_parts, feas_parts, ctl_parts):
            kernels.mesh_dense_scan(sh.value_base, sh.price, pt, fe, c, sh.scan, sh.delta,
                                    sh.offset)
        gathered = all_gather([sh.scan for sh in shards], mesh).view(-1, 4, T)
        kernels.mesh_dense_combine(gathered, p4t, feas_u8, ctl, eps, bt)
        for sh, b, c in zip(shards, broadcast(bt, mesh), ctl_parts):
            kernels.mesh_dense_resolve(b, c, sh.win_key, sh.offset)
        for sh, c in zip(shards, ctl_parts):
            kernels.mesh_dense_apply(sh.win_key, c, sh.price, sh.owner, sh.delta, sh.offset)
        deltas = all_gather([sh.delta for sh in shards], mesh).view(-1, T)
        kernels.mesh_dense_finish(deltas, feas_u8, ctl, p4t, max_iters)
    return p4t, ctl


def assign_auction_sharded(cost: torch.Tensor, mesh: Mesh, eps: float = 0.01,
                           max_iters: int = 500) -> AssignResult:
    """The dense auction with the cost rows sharded over ``mesh``
    (``protocol_tpu/parallel/auction.py:142``). ``cost`` is [P, T] with P
    divisible by the mesh size. The result, on the mesh's first device,
    equals the one-device ``assign_auction`` (the same ties). K17 on a
    card."""
    P, T = cost.shape
    D = mesh.size
    if P % D != 0:
        raise ValueError(f"P={P} not divisible by mesh size {D}; pad first")
    shards, stacked, task_feasible = _make_shards(mesh, cost)
    p4t, _ = _rounds(mesh, shards, stacked, task_feasible, float(eps), int(max_iters))
    return AssignResult(p4t, _invert(p4t, P))
