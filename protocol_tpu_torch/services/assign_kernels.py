"""The stateless kernel dispatch of the scheduler backend
(``protocol_tpu/services/scheduler_grpc.py:523-740
SchedulerBackendServicer._solve``), as a plain object over encoded
batches: no gRPC, no protobuf, so the servicer and in-process callers run
the same code.

Kernels, on the batches' device (the hand kernels on a card):

  "best"      each provider's cheapest compatible task (``solve_unbounded``:
              K8); not a matching, many providers may pick one task;
  "auction"   the dense auction over the tie-jittered cost
              (``auction_value_base`` + ``auction_dense``: K6 + K7) at
              ``eps or 0.01``, ``max_iters or 500``;
  "greedy"    the sequential greedy over the unjittered cost
              (``cost_only`` + ``assign_greedy``: K10 + K12);
  "sinkhorn"  entropic OT and its rounding over the unjittered cost
              (``cost_only`` + ``assign_sinkhorn``: K10 + K13 + K12) at
              ``eps or 0.05``, ``num_iters = max_iters or 200``;
  "topk"      bidirectional candidates (``CandidateMemo``: K1, a memo hit
              for a byte-identical repeat) and the eps-scaled sparse
              auction (K2, K9), or the warm one from the request's prices
              and seeds when both match the batch (K2 from a carried
              state).

  "jax[:D]"   (or the port's spelling "torch[:D]") the persistent warm
              arena (``protocol_tpu/services/scheduler_grpc.py:565-640``):
              one :class:`~protocol_tpu_torch.parallel.torch_arena.
              TorchSolveArena` over D views of the batches' device (0 =
              all), made anew when k or D changes; repeat calls with
              churned batches run its warm repair (K1, K3, K4, K5, K2).

"native", "native-mt[:N]" and "sinkhorn-mt[:N]" are refused with
:class:`KernelNotServed` (gRPC ``FAILED_PRECONDITION``: the reference's
client reads ``UNIMPLEMENTED`` as an old server and demotes its wire), any
other name with :class:`UnknownKernel` (``INVALID_ARGUMENT``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from protocol_tpu_torch.ops.assign import (
    assign_greedy,
    assign_sinkhorn,
    auction_dense,
    auction_value_base,
)
from protocol_tpu_torch.ops.sparse import (
    assign_auction_sparse_scaled,
    assign_auction_sparse_warm,
)
from protocol_tpu_torch.sched.cand_cache import CandidateMemo
from protocol_tpu_torch.sched.torch_backend import cost_only, solve_unbounded
from protocol_tpu_torch.services.session_store import (
    KernelNotServed,
    make_solve_arena,
    parse_session_kernel,
)

# candidates a task K1's forward launch selects at most
MAX_TOP_K_ON_CARD = 64


class UnknownKernel(ValueError):
    """A kernel name the backend does not know (``INVALID_ARGUMENT``)."""


class _SolveOut(NamedTuple):
    """Kernel output over the real (unpadded) row counts, on the host."""

    p4t: np.ndarray  # [T] i32, -1 = unassigned
    t4p: np.ndarray  # [P] i32, -1 = idle
    num_assigned: int
    price: Optional[np.ndarray]  # [P] f32 ("topk" and the arena)
    # the unary arena's last_stats, copied under the lock
    arena_stats: Optional[dict] = None


def _pad_pow2(enc, n_real: int):
    """Pad an encoded batch to the next pow2 bucket with zero rows marked
    valid=False (the real rows' ``valid`` is set), as the reference pads:
    padding rows are infeasible by mask, and the padded shapes keep the
    reference's shapes and so its bits (the jitter and the tile)."""
    if n_real <= 0:
        return enc
    target = 1 << (n_real - 1).bit_length()
    if target == n_real:
        return enc
    out = {}
    for f in dataclasses.fields(enc):
        a = getattr(enc, f.name)
        out[f.name] = torch.cat([a, a.new_zeros((target - n_real, *a.shape[1:]))])
    valid = torch.zeros(target, dtype=enc.valid.dtype, device=enc.valid.device)
    valid[:n_real] = 1
    out["valid"] = valid
    return dataclasses.replace(enc, **out)


def _host_i32(t: torch.Tensor, n: int) -> np.ndarray:
    return t[:n].to(torch.int32).cpu().numpy()


class KernelDispatch:
    """The backend's solve. One lock, ``lock``, serializes every solve on
    the device: the candidate memo, the unary arena and the kernels'
    launch counters are not thread-safe, and the server runs several
    workers. The servicer's session solves take the same lock."""

    def __init__(self):
        self.memo = CandidateMemo()
        self.lock = threading.Lock()
        self.arena = None  # the unary jax[:D] arena, made at its first call

    def solve(self, ep, er, weights, kernel: str, top_k: int = 0, eps: float = 0.0,
              max_iters: int = 0, warm_price: Optional[np.ndarray] = None,
              seed_p4t: Optional[np.ndarray] = None) -> _SolveOut:
        """One solve over unpadded encoded batches (the port's
        ``EncodedProviders`` / ``EncodedRequirements``, on one device):
        pads to the pow2 bucket, dispatches ``kernel``, reads the result
        back sliced to the real row counts. 0 for ``top_k``, ``eps`` or
        ``max_iters`` takes the kernel's default, as in the reference."""
        if kernel == "native" or kernel.startswith(("native-mt", "sinkhorn-mt")):
            raise KernelNotServed(
                f"kernel {kernel!r}: the reference's native C++ engines are not served "
                "by the port (ROADMAP queue A, M5)")
        arena = kernel.partition(":")[0] in ("jax", "torch")
        if arena:
            parsed = parse_session_kernel(kernel)
            if parsed is None:
                raise UnknownKernel(f"bad arena device suffix {kernel!r}")
        elif kernel not in ("best", "auction", "greedy", "sinkhorn", "topk"):
            raise UnknownKernel(f"unknown kernel {kernel!r}")
        P, T = ep.num, er.num
        if P == 0 or T == 0:  # degenerate batches are legal: nothing to match
            return _SolveOut(np.full(T, -1, np.int32), np.full(P, -1, np.int32), 0, None)
        k = max(top_k or 64, 1)
        if (kernel == "topk" or arena) and ep.gpu_count.is_cuda and k > MAX_TOP_K_ON_CARD:
            raise KernelNotServed(
                f"top_k={k}: K1 selects at most {MAX_TOP_K_ON_CARD} candidates a task")
        with self.lock:
            if arena:
                return self._arena_locked(_pad_pow2(ep, P), _pad_pow2(er, T), P, T, weights,
                                          k, parsed[1])
            return self._solve_locked(_pad_pow2(ep, P), _pad_pow2(er, T), P, T, weights,
                                      kernel, k, eps, max_iters, warm_price, seed_p4t)

    def _arena_locked(self, ep, er, P, T, weights, k: int, devices: int) -> _SolveOut:
        """The persistent warm arena over the padded batches: a changed k or
        device count changes the carried structure, so it makes a fresh
        arena (a cold solve)."""
        if self.arena is None or self.arena.k != k or self.arena.devices != devices:
            self.arena = make_solve_arena("jax", k=k, threads=devices,
                                          device=ep.gpu_count.device)
        p4t = np.asarray(self.arena.solve(ep, er, weights))[:T]
        t4p = np.full(P, -1, np.int32)
        seated = np.flatnonzero((p4t >= 0) & (p4t < P))
        t4p[p4t[seated]] = seated.astype(np.int32)
        price = np.asarray(self.arena.price)[:P].astype(np.float32)
        return _SolveOut(p4t, t4p, int((p4t >= 0).sum()), price, dict(self.arena.last_stats))

    def _solve_locked(self, ep, er, P, T, weights, kernel, k, eps, max_iters, warm_price,
                      seed_p4t) -> _SolveOut:
        if kernel == "best":
            t4p = _host_i32(solve_unbounded(ep, er, weights), P)
            return _SolveOut(np.full(T, -1, np.int32), t4p, int((t4p >= 0).sum()), None)
        price = None
        if kernel == "topk":
            p4t_full, t4p_full, price = self._topk(ep, er, P, T, weights, k, eps, max_iters,
                                                   warm_price, seed_p4t)
        elif kernel == "auction":
            # the same tie jitter as the in-process dense solve: the
            # reference's RemoteBatchMatcher parity with TpuBatchMatcher
            # rests on it
            value_base, feasible = auction_value_base(ep, er, weights)
            p4t_full, t4p_full, _, _ = auction_dense(value_base, feasible, eps or 0.01,
                                                     max_iters or 500)
        else:
            cost = cost_only(ep, er, weights)
            if kernel == "greedy":
                res = assign_greedy(cost)
            else:
                res = assign_sinkhorn(cost, eps=eps or 0.05, num_iters=max_iters or 200)
            p4t_full, t4p_full = res.provider_for_task, res.task_for_provider
        p4t = _host_i32(p4t_full, T)
        return _SolveOut(p4t, _host_i32(t4p_full, P), int((p4t >= 0).sum()), price)

    def _topk(self, ep, er, P, T, weights, k, eps, max_iters, warm_price, seed_p4t):
        t_padded, p_padded = er.num, ep.num
        tile = min(1024, t_padded)  # divides the pow2 bucket
        cand_p, cand_c = self.memo.get(ep, er, weights, k=k, tile=tile, reverse_r=8, extra=16)
        dev = cand_c.device
        if (warm_price is not None and seed_p4t is not None
                and len(warm_price) == P and len(seed_p4t) == T):
            # the warm state rode the wire, untrusted: non-finite prices
            # become 0, out-of-range seeds -1, and a provider seeded twice
            # keeps only its first task (the warm auction needs an
            # injective seed)
            price0 = np.zeros(p_padded, np.float32)
            price0[:P] = np.nan_to_num(np.asarray(warm_price, np.float32),
                                       nan=0.0, posinf=0.0, neginf=0.0)
            seeds = np.asarray(seed_p4t, np.int32).copy()
            seeds = np.where((seeds >= 0) & (seeds < P), seeds, -1)
            pos = seeds >= 0
            _, first = np.unique(seeds[pos], return_index=True)
            keep = np.zeros(int(pos.sum()), bool)
            keep[first] = True
            seeds[np.flatnonzero(pos)[~keep]] = -1
            p4t0 = np.full(t_padded, -1, np.int32)
            p4t0[:T] = seeds
            res, price = assign_auction_sparse_warm(
                cand_p, cand_c, p_padded,
                price0=torch.from_numpy(price0).to(dev), p4t0=torch.from_numpy(p4t0).to(dev),
                eps=eps or 0.02, max_iters=max_iters or 20000,
            )
        else:
            res, price, _ = assign_auction_sparse_scaled(
                cand_p, cand_c, p_padded, eps_end=eps or 0.02,
                max_iters_per_phase=max_iters or 4000, with_state=True,
            )
        return (res.provider_for_task, res.task_for_provider,
                price[:P].to(torch.float32).cpu().numpy())
