"""Build, load and launch the port's hand kernels for Hopper.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/kernels/`` beside
the package, at first use (one ``nvcc`` per source, all started together),
and loaded with ``ctypes``. A library's file name carries a hash of its
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source is rebuilt and never mixed with an old build.

Flags: ``-O3 -fmad=false`` and no fast-math, so every f32 operation in a
kernel rounds once, as PyTorch's eager ops do.

Every wrapper checks its inputs, launches on PyTorch's current stream of
its inputs' card with that card as the current device, raises if the
launch was refused, and adds one to its entry in
:data:`LAUNCHES` per kernel launch; nothing else counts there.

In-place timing (off by default): after :func:`time_in_place` ``(True)``
every launch is recorded between two CUDA events on its stream, and
:func:`in_place_ms` returns the device milliseconds and launches summed
per :data:`LAUNCHES` key: what each kernel cost the run it was part of.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("candidates", "auction", "repair", "dense", "cleanup", "binpack", "greedy", "sinkhorn",
           "blocked", "mesh_auction", "mesh_dense")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel since the last reset_launches()
LAUNCHES = {
    "candidates_forward_rows": 0, "candidates_forward_rows_biased": 0,
    "candidates_reverse": 0, "candidates_bidir": 0, "auction_phase": 0,
    "candidates_reverse_blocks": 0,
    "repair_enter": 0, "repair_tile_min": 0, "repair_refold": 0,
    "dense_value_base": 0, "dense_auction": 0, "unbounded_best": 0, "greedy_cleanup": 0,
    "cost_block": 0, "binpack_ffd": 0, "binpack_ffd_device": 0, "greedy_assign": 0,
    "sinkhorn": 0,
    "blocked_feasibility": 0, "blocked_row_lse": 0, "blocked_col_lse": 0,
    "blocked_col_partial": 0, "pair_cost": 0,
    "mesh_segment": 0, "mesh_round_bid": 0, "mesh_round_resolve": 0, "mesh_round_apply": 0,
    "mesh_dense_scan": 0, "mesh_dense_combine": 0, "mesh_dense_resolve": 0,
    "mesh_dense_apply": 0, "mesh_dense_finish": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}

# in-place timing: event pairs (key, start, end) not yet summed, None while
# off; and the sums, key -> [device ms, launches]
_TIMED: list | None = None
_IN_PLACE: dict[str, list] = {}
_FOLD_AT = 4096  # pending pairs that trigger a fold of the finished ones

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the hand kernels are built with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every library that is missing, one ``nvcc`` per source, all
    at once. Returns the wall seconds spent; raises on a failed build.
    The compiler's report (registers, spills) lands in :data:`BUILD_LOG`."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        if name == "candidates":
            lib.k1_reverse.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _U,
                _P, _P, _P, _P, _P, _P, _P,
            ]
            lib.k1_bidir.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _U,
                _P, _P, _P, _P, _P, _P, _P, _P, _P,
            ]
            lib.k1_forward_rows.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P, _I, _I, _I, _U, _P, _P, _P, _P,
                _P,
            ]
            lib.k1_reverse_blocks.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
            ]
            lib.k4_repair_tile_min.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P, _I, _F, _P, _P, _P,
            ]
            lib.k3_repair_enter.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _I, _U, _P, _P, _P, _P,
            ]
            lib.k10_cost_block.argtypes = [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P]
            lib.k6_value_base.argtypes = [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P]
            lib.k8_unbounded_best.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P,
            ]
            for fn in ("k1_reverse", "k1_bidir", "k1_forward_rows", "k1_reverse_blocks",
                       "k4_repair_tile_min", "k3_repair_enter", "k10_cost_block",
                       "k6_value_base", "k8_unbounded_best"):
                getattr(lib, fn).restype = _I
        elif name == "repair":
            lib.k5_repair_refold.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
            lib.k5_group.argtypes = [_I]
            for fn in ("k5_repair_refold", "k5_group"):
                getattr(lib, fn).restype = _I
        elif name == "dense":
            lib.k7_dense_auction.argtypes = [
                _P, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            ]
            lib.k7_route.argtypes = [_I]
            for fn in ("k7_dense_auction", "k7_route"):
                getattr(lib, fn).restype = _I
        elif name == "cleanup":
            lib.k9_greedy_cleanup.argtypes = [_P, _P, _I, _I, _P, _P, _I, _P, _P]
            lib.k9_greedy_cleanup.restype = _I
        elif name == "binpack":
            lib.k11_binpack_ffd.argtypes = [
                _P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P,
            ]
            lib.k11_slots.argtypes = [_I, _I, ctypes.c_longlong, _I]
            for fn in ("k11_binpack_ffd", "k11_slots"):
                getattr(lib, fn).restype = _I
        elif name == "greedy":
            lib.k12_greedy.argtypes = [_P, _I, _I, _P, _I, _P, _P]
            lib.k12_greedy.restype = _I
        elif name == "blocked":
            lib.k14_feasibility.argtypes = [
                _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P,
            ]
            lib.k14_lse.argtypes = [_P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P, _P]
            lib.k14_col_partial.argtypes = [
                _P, _P, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P,
            ]
            lib.k15_pair_cost.argtypes = [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P]
            for fn in ("k14_feasibility", "k14_lse", "k14_col_partial", "k15_pair_cost"):
                getattr(lib, fn).restype = _I
        elif name == "mesh_auction":
            lib.k16_round_bid.argtypes = [
                _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            ]
            lib.k16_round_resolve.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P]
            lib.k16_round_apply.argtypes = [
                _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            ]
            for fn in ("k16_round_bid", "k16_round_resolve", "k16_round_apply"):
                getattr(lib, fn).restype = _I
        elif name == "mesh_dense":
            lib.k17_scan.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
            lib.k17_combine.argtypes = [_P, _P, _P, _P, _I, _I, _F, _P, _P]
            lib.k17_resolve.argtypes = [_P, _P, _I, _I, _I, _P, _P]
            lib.k17_apply.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P]
            lib.k17_finish.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
            for fn in ("k17_scan", "k17_combine", "k17_resolve", "k17_apply", "k17_finish"):
                getattr(lib, fn).restype = _I
        elif name == "sinkhorn":
            lib.k13_sinkhorn.argtypes = [_P, _I, _I, _F, _I] + [_P] * 18
            lib.k13_dense_layout.argtypes = [ctypes.c_longlong, _I, _I]
            for fn in ("k13_sinkhorn", "k13_dense_layout"):
                getattr(lib, fn).restype = _I
        else:
            lib.k2_auction_phase.argtypes = [
                _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
            ]
            lib.k16_mesh_segment.argtypes = [
                _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
            ]
            lib.k2_active_clusters.argtypes = [_I, _P]
            for fn in ("k2_auction_phase", "k16_mesh_segment", "k2_active_clusters"):
                getattr(lib, fn).restype = _I
        _LIBS[name] = lib
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch refused (cudaError {rc})")


def _launch(key: str, fn, *args, what: str | None = None) -> None:
    """Call ``fn``, a C entry point that launches one kernel on the stream
    it is given, raise if the launch was refused, and count it under
    ``key``; with in-place timing on, between two events on the current
    stream (the launch's: wrappers run on their inputs' card)."""
    if _TIMED is None:
        _check(fn(*args), what or key)
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _check(fn(*args), what or key)
        end.record()
        _TIMED.append((key, start, end))
        if len(_TIMED) >= _FOLD_AT:
            _fold(wait=False)
    LAUNCHES[key] += 1


def _fold(wait: bool) -> None:
    """Add the pending event pairs to the sums: all of them after waiting
    for each (``wait``), else only those whose end has passed."""
    keep = []
    for key, start, end in _TIMED:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((key, start, end))
            continue
        acc = _IN_PLACE.setdefault(key, [0.0, 0])
        acc[0] += start.elapsed_time(end)
        acc[1] += 1
    _TIMED[:] = keep


def time_in_place(on: bool) -> None:
    """Switch in-place timing on, with every sum set to 0, or off (the sums
    so far stay readable). Costs two event records a launch while on."""
    global _TIMED
    if on:
        _IN_PLACE.clear()
        _TIMED = []
    elif _TIMED is not None:
        _fold(wait=True)
        _TIMED = None


@contextlib.contextmanager
def untimed():
    """Launches made inside are not timed in place (a run's checks)."""
    global _TIMED
    saved, _TIMED = _TIMED, None
    try:
        yield
    finally:
        _TIMED = saved


def in_place_ms() -> dict[str, dict]:
    """The in-place sums since timing was switched on: {key: {"ms": device
    ms over its launches, "launches": n}} for every key that launched.
    Waits for the pending launches to end."""
    if _TIMED:
        _fold(wait=True)
    return {k: {"ms": v[0], "launches": v[1]} for k, v in _IN_PLACE.items()}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_device(wrapper):
    """Run a launch wrapper with its inputs' card as the current device (the
    first argument's: a tensor, or encoded columns), so its launches and
    the launchers' device queries go to that card's stream. A mesh's shards
    on several cards launch in turn from one thread, and CUDA refuses a
    launch into a stream of another device than the current one. The
    device is switched only when it differs: a launch on the current card
    (every launch of a one-card run) pays one device query."""

    @functools.wraps(wrapper)
    def run(first, *args, **kwargs):
        dev = first.gpu_count.device if hasattr(first, "gpu_count") else first.device
        if dev.type != "cuda" or dev.index == torch.cuda.current_device():
            return wrapper(first, *args, **kwargs)
        with torch.cuda.device(dev):
            return wrapper(first, *args, **kwargs)

    return run


def _cols(obj, spec, device) -> ctypes.Array:
    """Pointer array over the columns of ``obj`` in ``spec`` order, after
    checking each one's device, dtype and contiguity."""
    ptrs = []
    for name, dtype in spec:
        t = getattr(obj, name)
        want = _TORCH_DTYPES[dtype]
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"column {name}: need a contiguous {want} tensor on {device}, "
                f"got {t.dtype} on {t.device}"
            )
        ptrs.append(t.data_ptr())
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


_TORCH_DTYPES = {
    np.int32: torch.int32, np.uint8: torch.uint8,
    np.float32: torch.float32, np.uint32: torch.uint32,
}


def _k1_setup(ep, er, weights, aux_floats: int | None = None):
    """(device, provider and requirement column pointers, (P, T, K, W),
    the weights, aux): aux holds ``aux_floats`` floats (default the 2 (P +
    T) per-row terms the launches' prep step writes), None at 0."""
    from protocol_tpu_torch.native.arena import _P_SPEC, _R_SPEC

    dev = ep.gpu_count.device
    K = er.max_gpu_options
    if K > 8:
        raise ValueError(f"K1 takes at most 8 GPU options per requirement, got {K}")
    pcols = _cols(ep, _P_SPEC, dev)
    rcols = _cols(er, _R_SPEC, dev)
    shape = (ep.num, er.num, K, int(er.gpu_model_mask.shape[2]))
    w = (weights.price, weights.load, weights.proximity, weights.priority)
    # per-row cost terms the launch's prep step writes (see candidates.cu)
    n_aux = 2 * (ep.num + er.num) if aux_floats is None else aux_floats
    aux = torch.empty(n_aux, dtype=torch.float32, device=dev) if n_aux else None
    return dev, pcols, rcols, shape, w, aux


def jitter_offset(offset: int) -> int:
    """The jitter offset as K1 takes it, a uint32: ``offset`` mod 2^32.
    An offset outside the int32 range is refused with OverflowError, as
    the reference's jitted call refuses it."""
    offset = int(offset)
    if not -(1 << 31) <= offset < (1 << 31):
        raise OverflowError(f"jitter offset {offset} does not fit in int32")
    return offset & 0xFFFFFFFF


# K1's layout (csrc/candidates.cu): a block of 4 warps in groups of `split`
# warps (at most K1_MAX_SPLIT, a share of the providers each), each group
# over `rows_per_warp` task rows
K1_MAX_SPLIT = 2
K1_MAX_ROWS = 8
# warps the rows launch aims for: two a row at the repair's ~655 rows,
# eight rows a warp at the cold pass's 65,536
K1_TARGET_WARPS = 2_048


def k1_rows_layout(n_rows: int) -> tuple[int, int]:
    """(rows_per_warp, split) of K1's rows launch over ``n_rows`` rows: 8
    rows a warp group, halved, then the group split over 2 warps (a share
    of the providers each), until the launch has K1_TARGET_WARPS warps or
    the split is K1_MAX_SPLIT."""
    rw, split = K1_MAX_ROWS, 1
    while -(-n_rows // rw) * split < K1_TARGET_WARPS:
        if rw > 1:
            rw //= 2
        elif split < K1_MAX_SPLIT:
            split *= 2
        else:
            break
    return rw, split


def k1_tile_rows(tile: int) -> int:
    """Rows a warp in K1's reverse side: the largest power of two <= 8 that
    divides ``tile``, so that no warp's rows straddle two tiles."""
    rw = K1_MAX_ROWS
    while tile % rw:
        rw //= 2
    return rw


def _k1_reverse_out(P: int, T: int, tile: int, r: int, rt: int, dev, what: str):
    """Check the reverse side's arguments; the key buffer, the pools and the
    fold's outputs."""
    if not 1 <= r <= 8 or tile < 1 or T % tile != 0:
        raise ValueError(f"{what} takes r <= 8 and T % tile == 0 (r={r}, T={T}, tile={tile})")
    if not 1 <= rt <= min(r, tile):
        raise ValueError(f"{what} takes 1 <= rt <= min(r, tile) (rt={rt}, r={r}, tile={tile})")
    n_pool = T // tile * rt
    # the reverse keys (cost, task) as int64: 8 bytes a pool entry, 32 MB at
    # 65,536^2 (tile 1,024) and at 100,000^2 (tile 2,500); reset by the launch
    rkey = torch.empty((P, n_pool), dtype=torch.int64, device=dev)
    pool_t = torch.empty((P, n_pool), dtype=torch.int32, device=dev)
    pool_c = torch.empty((P, n_pool), dtype=torch.float32, device=dev)
    rev_t = torch.empty((P, r), dtype=torch.int32, device=dev)
    rev_c = torch.empty((P, r), dtype=torch.float32, device=dev)
    return rkey, pool_t, pool_c, rev_t, rev_c


@_on_device
def candidates_reverse(ep, er, weights, tile: int, r: int, rt: int, offset: int = 0):
    """K1, reverse launch (``csrc/candidates.cu``): each tile's stable
    top-rt tasks per provider (the pools), folded into each provider's
    best r from an (INFEASIBLE, -1) carry, the jitter keyed on (task id +
    ``offset``) mod 2^32. The task ids written are the rows of ``er``.
    Returns (rev_t [P, r] unmasked, rev_c, pool_t [P, n_tiles * rt],
    pool_c)."""
    offset = jitter_offset(offset)
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    rkey, pool_t, pool_c, rev_t, rev_c = _k1_reverse_out(P, T, tile, r, rt, dev, "K1 reverse")
    _launch("candidates_reverse", _lib("candidates").k1_reverse,
        pcols, rcols, P, T, K, W, *w, tile, r, rt, k1_tile_rows(tile), offset, aux.data_ptr(),
        rkey.data_ptr(), pool_t.data_ptr(), pool_c.data_ptr(), rev_t.data_ptr(),
        rev_c.data_ptr(), _stream(pool_t),
    )
    return rev_t, rev_c, pool_t, pool_c


@_on_device
def candidates_bidir(ep, er, weights, k: int, tile: int, r: int, rt: int, offset: int = 0):
    """K1, the fused cold pass (``csrc/candidates.cu``): every task's k
    cheapest providers and the reverse pools and fold of
    :func:`candidates_reverse`, each cell scored once, the jitter keyed on
    (task id + ``offset``) mod 2^32. Returns (fwd_p [T, k] with -1 where the
    cost is >= INFEASIBLE/2, fwd_c, rev_t [P, r] unmasked, rev_c, pool_t
    [P, n_tiles * rt], pool_c)."""
    if not 1 <= k <= 64 or k > ep.num:
        raise ValueError(f"K1 takes 1 <= k <= min(64, P) candidates a task, "
                         f"got k={k} with P={ep.num}")
    offset = jitter_offset(offset)
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    rkey, pool_t, pool_c, rev_t, rev_c = _k1_reverse_out(P, T, tile, r, rt, dev, "K1 bidir")
    fwd_p = torch.empty((T, k), dtype=torch.int32, device=dev)
    fwd_c = torch.empty((T, k), dtype=torch.float32, device=dev)
    _launch("candidates_bidir", _lib("candidates").k1_bidir,
        pcols, rcols, P, T, K, W, *w, k, tile, r, rt, k1_tile_rows(tile), offset,
        aux.data_ptr(), rkey.data_ptr(), fwd_p.data_ptr(), fwd_c.data_ptr(), pool_t.data_ptr(),
        pool_c.data_ptr(), rev_t.data_ptr(), rev_c.data_ptr(), _stream(pool_t),
    )
    return fwd_p, fwd_c, rev_t, rev_c, pool_t, pool_c


# K2's cluster: the largest size of 16 (non-portable) and 8 whose
# 1,024-thread blocks the card co-schedules, queried once a card
K2_CLUSTERS = (16, 8)
_K2_CLUSTER: dict[int, int] = {}
# once at most this many tasks are open, K2's block 0 runs the rest of the
# launch alone (one block's bid pass: two tasks a warp), with block
# barriers and L1, which beat cluster barriers and L2 there (PERF.md)
K2_ONE_BLOCK_OPEN = 64


def k2_cluster(dev: torch.device) -> int:
    """The cluster size K2 launches with on ``dev``: the first of
    :data:`K2_CLUSTERS` of which ``cudaOccupancyMaxActiveClusters`` finds
    room for one cluster. Raises if none fits."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _K2_CLUSTER:
        n = ctypes.c_int(0)
        with torch.cuda.device(idx):
            for c in K2_CLUSTERS:
                _check(_lib("auction").k2_active_clusters(c, ctypes.addressof(n)),
                       f"k2_active_clusters({c})")
                if n.value >= 1:
                    _K2_CLUSTER[idx] = c
                    break
            else:
                raise RuntimeError(f"K2: the card fits no cluster of {K2_CLUSTERS} blocks")
    return _K2_CLUSTER[idx]


@_on_device
def auction_phase(
    cand_safe, value_base, task_feasible, give_up, state,
    P: int, eps: float, max_iters: int, B: int, stall_limit: int,
    work_out: dict | None = None, cluster: int | None = None,
):
    """K2: one eps phase of the frontier auction (``csrc/auction.cu``) in one
    launch of one thread-block cluster of ``cluster`` blocks (default
    :func:`k2_cluster`; a size the card refuses raises; block 0 finishes
    alone once :data:`K2_ONE_BLOCK_OPEN` or fewer tasks are open). ``state`` = (it,
    price, owner, p4t, retired); returns the new state (fresh tensors;
    ``it`` a 0-d int32) and ``stall`` (0-d int32).
    ``work_out["frontier_rows"]`` receives the frontier rows bid over all
    rounds (a 0-d tensor), the data-dependent work of the launch."""
    T, K = value_base.shape
    dev = value_base.device
    _, price, owner, p4t, retired = state
    price = price.to(torch.float32).clone()
    owner = owner.to(torch.int32).clone()
    p4t = p4t.to(torch.int32).clone()
    retired = retired.to(torch.bool).clone()
    cand_safe = cand_safe.to(torch.int32).contiguous()
    value_base = value_base.to(torch.float32).contiguous()
    feasible = task_feasible.to(torch.bool).contiguous()
    give_up = give_up.to(torch.float32).reshape(1).contiguous()
    for t in (cand_safe, value_base, feasible, give_up, price, owner, p4t, retired):
        if t.device != dev:
            raise ValueError(f"K2: every input must lie on {dev}, got {t.device}")
    if price.shape[0] != P or owner.shape[0] != P or p4t.shape[0] != T:
        raise ValueError("K2: state shapes do not match the candidate arrays")
    if K > 128 or T > 1_638_400:
        raise ValueError(f"K2 takes K <= 128 candidates and T <= 1,638,400 tasks, got {K}, {T}")
    C = k2_cluster(dev) if cluster is None else int(cluster)
    f_idx, fr_p1, fr_key, win_key = _phase_scratch(B, P, dev)
    ctl = torch.empty(MESH_CTL, dtype=torch.int32, device=dev)
    _launch("auction_phase", _lib("auction").k2_auction_phase,
        cand_safe.data_ptr(), value_base.data_ptr(), feasible.data_ptr(),
        give_up.data_ptr(), T, K, B, P, max_iters, stall_limit, eps, K2_ONE_BLOCK_OPEN,
        price.data_ptr(), owner.data_ptr(), p4t.data_ptr(), retired.data_ptr(),
        f_idx.data_ptr(), fr_p1.data_ptr(), fr_key.data_ptr(), win_key.data_ptr(),
        ctl.data_ptr(), C, _stream(ctl), what=f"auction_phase (cluster of {C})",
    )
    if work_out is not None:
        work_out["frontier_rows"] = ctl[CTL_ROWS]
    return (ctl[CTL_IT], price, owner, p4t, retired), ctl[CTL_STALL]


def _phase_scratch(n_front: int, P: int, dev):
    """The phase kernel's scratch for frontiers of ``n_front`` entries:
    f_idx, fr_p1 (two round parities), fr_key, and the 64-bit key buffers
    win_key [2, P], zero as the launch takes them."""
    return (torch.empty(n_front, dtype=torch.int32, device=dev),
            torch.empty((2, n_front), dtype=torch.int32, device=dev),
            torch.empty(n_front, dtype=torch.int64, device=dev),
            torch.zeros((2, P), dtype=torch.int64, device=dev))


def _ids(ids: torch.Tensor, n: int, dev, what: str) -> torch.Tensor:
    """A non-empty int32 id vector on ``dev`` with every id in [0, n)."""
    if ids.device != dev or ids.dim() != 1 or ids.numel() == 0:
        raise ValueError(f"{what}: need a non-empty 1-d id tensor on {dev}")
    ids = ids.to(torch.int32).contiguous()
    if int(ids.min()) < 0 or int(ids.max()) >= n:
        raise ValueError(f"{what}: ids out of range [0, {n})")
    return ids


@_on_device
def candidates_forward_rows(ep, er, weights, k: int, t_ids: torch.Tensor,
                            rows_per_warp: int | None = None, split: int | None = None,
                            offset: int = 0, bias: torch.Tensor | None = None):
    """K1, forward launch (``csrc/candidates.cu``): the k cheapest
    providers of each task in ``t_ids`` (global ids; the jitter is keyed
    on (id + ``offset``) mod 2^32), (p [R, k] i32, c [R, k] f32), row i for
    task t_ids[i]. A warp group takes ``rows_per_warp`` rows (1, 2, 4 or
    8) and its ``split`` warps (1 or 2) a share of the providers each;
    by default :func:`k1_rows_layout` of R. With ``bias`` ([P] f32, the
    reference's ``provider_offset``) the selection runs on cost + bias[p]
    over the feasible cells, c holds the true costs and p is -1 where the
    selection is >= INFEASIBLE/2."""
    if not 1 <= k <= 64 or k > ep.num:
        raise ValueError(f"K1 forward takes 1 <= k <= min(64, P) candidates a task, "
                         f"got k={k} with P={ep.num}")
    offset = jitter_offset(offset)
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    t_ids = _ids(t_ids, T, dev, "candidates_forward_rows")
    if bias is not None and (bias.device != dev or bias.dtype != torch.float32
                             or bias.shape != (P,) or not bias.is_contiguous()):
        raise ValueError(f"candidates_forward_rows: bias must be a contiguous [{P}] f32 "
                         f"tensor on {dev}")
    R = t_ids.numel()
    rw, sp = k1_rows_layout(R)
    rw, sp = rows_per_warp or rw, split or sp
    if rw not in (1, 2, 4, 8) or sp not in (1, 2):
        raise ValueError(f"candidates_forward_rows takes rows_per_warp in 1, 2, 4, 8 and split "
                         f"in 1, 2, got {rw}, {sp}")
    out_p = torch.empty((R, k), dtype=torch.int32, device=dev)
    out_c = torch.empty((R, k), dtype=torch.float32, device=dev)
    # the biased instantiation is a kernel of its own, counted apart
    _launch("candidates_forward_rows" if bias is None else "candidates_forward_rows_biased",
            _lib("candidates").k1_forward_rows,
            pcols, rcols, P, T, K, W, *w, k, t_ids.data_ptr(), R, rw, sp, offset,
            None if bias is None else bias.data_ptr(), aux.data_ptr(), out_p.data_ptr(),
            out_c.data_ptr(), _stream(out_p), what="candidates_forward_rows")
    return out_p, out_c


def _pools(pool_t, pool_c, P: int, n_tiles: int, dev, what: str) -> None:
    for t, dt in ((pool_t, torch.int32), (pool_c, torch.float32)):
        if t.device != dev or t.dtype != dt or t.shape != (P, n_tiles) or not t.is_contiguous():
            raise ValueError(f"{what}: pools must be contiguous [{P}, {n_tiles}] tensors on {dev}")


@_on_device
def candidates_reverse_blocks(ep, er, weights, tile: int, blk_p, blk_j, pool_t, pool_c) -> None:
    """K1 reverse, blocks variant (``csrc/candidates.cu``): rescores the
    (provider blk_p[b], tile blk_j[b]) blocks, ordered by tile, and writes
    each block's first argmin into ``pool_t`` / ``pool_c`` [P, n_tiles] in
    place (rt = 1)."""
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    if tile < 1 or T % tile != 0:
        raise ValueError(f"K1 reverse blocks: T={T} not divisible by tile={tile}")
    n_tiles = T // tile
    _pools(pool_t, pool_c, P, n_tiles, dev, "candidates_reverse_blocks")
    blk_p = _ids(blk_p, P, dev, "candidates_reverse_blocks")
    blk_j = _ids(blk_j, n_tiles, dev, "candidates_reverse_blocks")
    if blk_p.shape != blk_j.shape:
        raise ValueError("candidates_reverse_blocks: blk_p and blk_j differ in length")
    if blk_j.numel() > 1 and not bool((blk_j[1:] >= blk_j[:-1]).all()):
        raise ValueError("candidates_reverse_blocks: blocks must come ordered by tile")
    n = blk_p.numel()
    rkey = torch.empty(n, dtype=torch.int64, device=dev)  # the slices' least keys
    lo = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)  # each tile's first block
    _launch("candidates_reverse_blocks", _lib("candidates").k1_reverse_blocks,
        pcols, rcols, P, T, K, W, *w, tile, blk_p.data_ptr(), blk_j.data_ptr(), n,
        aux.data_ptr(), rkey.data_ptr(), lo.data_ptr(), pool_t.data_ptr(), pool_c.data_ptr(),
        _stream(pool_t),
    )


@_on_device
def repair_enter(ep, er, weights, p_ids, thresh, offset: int = 0):
    """K3 (``csrc/candidates.cu``, a list launch of K1's layout): per task,
    whether some dirty provider (global ids ``p_ids``) has a feasible fresh
    cost <= ``thresh`` [T] (the stored k-th forward cost), the jitter keyed
    on (row + ``offset``) mod 2^32. Returns enter [T] bool."""
    offset = jitter_offset(offset)
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    p_ids = _ids(p_ids, P, dev, "repair_enter")
    if thresh.device != dev or thresh.dtype != torch.float32 or thresh.shape != (T,):
        raise ValueError(f"repair_enter: thresh must be a [{T}] f32 tensor on {dev}")
    thresh = thresh.contiguous()
    enter = torch.empty(T, dtype=torch.uint8, device=dev)
    _launch("repair_enter", _lib("candidates").k3_repair_enter,
        pcols, rcols, P, T, K, W, *w, p_ids.data_ptr(), p_ids.numel(), offset,
        thresh.data_ptr(), aux.data_ptr(), enter.data_ptr(), _stream(enter),
    )
    return enter.bool()


@_on_device
def repair_tile_min(ep, er, weights, t_ids, tile: int, pad: float):
    """K4 (``csrc/candidates.cu``): per (provider, tile), the least fresh cost
    over the tasks ``t_ids`` (global ids, ascending, unique) of that tile;
    ``pad`` where the tile holds none of them. Returns [P, n_tiles] f32."""
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    if tile < 1 or T % tile != 0:
        raise ValueError(f"repair_tile_min: T={T} not divisible by tile={tile}")
    t_ids = _ids(t_ids, T, dev, "repair_tile_min")
    if t_ids.numel() > 1 and not bool((t_ids[1:] > t_ids[:-1]).all()):
        raise ValueError("repair_tile_min: task ids must ascend strictly")
    min_tile = torch.full((P, T // tile), pad, dtype=torch.float32, device=dev)
    _launch("repair_tile_min", _lib("candidates").k4_repair_tile_min,
        pcols, rcols, P, T, K, W, *w, tile, t_ids.data_ptr(), t_ids.numel(), pad,
        aux.data_ptr(), min_tile.data_ptr(), _stream(min_tile),
    )
    return min_tile


# K5's lanes a provider (csrc/repair.cu: k5_group), mirrored so that the
# layout is known from the shape without a card: the power of two at or
# above n_tiles / K5_LANE_ENTRIES, from 1 to 32
K5_LANE_ENTRIES = 32


def refold_group(n_tiles: int) -> int:
    """Lanes K5 gives a provider with ``n_tiles`` pool entries."""
    g = 1
    while g < 32 and g * K5_LANE_ENTRIES < n_tiles:
        g *= 2
    return g


@_on_device
def repair_refold(pool_t, pool_c, r: int, d_fold: int = 1):
    """K5 (``csrc/repair.cu``): each provider's best r of its pool entries
    [P, n_tiles] from the (INFEASIBLE, -1) carry, as the reference folds
    them in ``d_fold`` lanes of consecutive tiles and merges the lanes: the
    stable top-r in the IEEE total order of the costs (-0 before +0; an
    entry enters below INFEASIBLE, a negative NaN too). A group of
    :func:`refold_group` lanes a provider. Returns (rev_t [P, r] with -1
    where the cost is not below INFEASIBLE/2, rev_c [P, r], the entries'
    cost bits)."""
    dev = pool_c.device
    P, n_tiles = pool_c.shape
    _pools(pool_t, pool_c, P, n_tiles, dev, "repair_refold")
    if not 1 <= r <= 8 or d_fold < 1 or n_tiles % d_fold != 0:
        raise ValueError(f"K5 takes 1 <= r <= 8 and d_fold dividing n_tiles, got r={r}, "
                         f"d_fold={d_fold}, n_tiles={n_tiles}")
    rev_t = torch.empty((P, r), dtype=torch.int32, device=dev)
    rev_c = torch.empty((P, r), dtype=torch.float32, device=dev)
    _launch("repair_refold", _lib("repair").k5_repair_refold,
        pool_t.data_ptr(), pool_c.data_ptr(), P, n_tiles, r, d_fold,
        rev_t.data_ptr(), rev_c.data_ptr(), _stream(rev_c),
    )
    return rev_t, rev_c


@_on_device
def dense_value_base(ep, er, weights):
    """K6 (``csrc/candidates.cu``, a list launch of K1's layout): the dense
    auction's value rows, (value_base [T, P] f32 = -(jittered cost), -1e18
    where the cost is >= INFEASIBLE/2; task_feasible [T] bool)."""
    if ep.num < 1 or er.num < 1:
        raise ValueError("K6 takes at least one provider and one task")
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    value_base = torch.empty((T, P), dtype=torch.float32, device=dev)
    feasible = torch.empty(T, dtype=torch.uint8, device=dev)  # zeroed by the C entry
    _launch("dense_value_base", _lib("candidates").k6_value_base,
        pcols, rcols, P, T, K, W, *w, aux.data_ptr(), value_base.data_ptr(),
        feasible.data_ptr(), _stream(value_base),
    )
    return value_base, feasible.bool()


# K7's route (csrc/dense.cu: k7_route), mirrored so that it is known from
# the shape without a card: the round's prices in shared memory where P x 4
# bytes fit in K7_PRICE_MAX_BYTES, else read through L2
K7_PRICE_MAX_BYTES = 200 * 1024


def dense_route(P: int) -> str:
    """K7's route for P providers: "shared" (the round's prices staged in
    shared memory) or "global" (read through L2), from the shape alone."""
    return "shared" if P * 4 <= K7_PRICE_MAX_BYTES else "global"


@_on_device
def dense_auction(value_base, task_feasible, eps: float, max_iters: int,
                  work_out: dict | None = None):
    """K7 (``csrc/dense.cu``): the dense Jacobi auction from scratch duals,
    every round in one cooperative launch over a compacted list of the
    open slots. Returns (p4t [T] i32, t4p [P] i32, price [P] f32, rounds
    0-d i64); ``work_out["open_rows"]`` receives the open rows summed over
    the rounds (0-d i64)."""
    T, P = value_base.shape
    dev = value_base.device
    if value_base.dtype != torch.float32 or not value_base.is_contiguous():
        raise ValueError("K7: value_base must be a contiguous f32 [T, P] tensor")
    if T < 1 or P < 1:
        raise ValueError("K7 takes at least one task and one provider")
    feasible = task_feasible.to(torch.uint8).contiguous()
    if feasible.device != dev or feasible.shape != (T,):
        raise ValueError(f"K7: task_feasible must be a [{T}] tensor on {dev}")
    if value_base.data_ptr() % 16:  # the rows are read as 16-byte vectors
        value_base = value_base.clone()
    price = torch.zeros(P, dtype=torch.float32, device=dev)
    owner = torch.full((P,), -1, dtype=torch.int32, device=dev)
    p4t = torch.full((T,), -1, dtype=torch.int32, device=dev)
    fr_p1 = torch.empty((2, T), dtype=torch.int32, device=dev)
    fr_key = torch.empty(T, dtype=torch.int64, device=dev)
    win_key = torch.zeros((2, P), dtype=torch.int64, device=dev)
    open_list = torch.empty((2, T), dtype=torch.int32, device=dev)
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)  # barrier, three list counts
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    _launch("dense_auction", _lib("dense").k7_dense_auction,
        value_base.data_ptr(), feasible.data_ptr(), T, P, eps, max_iters,
        price.data_ptr(), owner.data_ptr(), p4t.data_ptr(), fr_p1.data_ptr(),
        fr_key.data_ptr(), win_key.data_ptr(), open_list.data_ptr(), ctl.data_ptr(),
        out.data_ptr(), _stream(out),
    )
    if work_out is not None:
        work_out["open_rows"] = out[1]
    return p4t, owner, price, out[0]


@_on_device
def unbounded_best(ep, er, weights):
    """K8 (``csrc/candidates.cu``, a list launch of K1's layout): per
    provider, the first argmin over the tasks of the unjittered cost (-0
    and +0 equal, a NaN below every cost, as the reference's argmin returns
    a row's first NaN), -1 where it is >= INFEASIBLE/2 or NaN. Returns best
    [P] i32."""
    if ep.num < 1 or er.num < 1:
        raise ValueError("K8 takes at least one provider and one task")
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    rkey = torch.empty(P, dtype=torch.int64, device=dev)  # the ranges' least keys
    best = torch.empty(P, dtype=torch.int32, device=dev)
    _launch("unbounded_best", _lib("candidates").k8_unbounded_best,
        pcols, rcols, P, T, K, W, *w, aux.data_ptr(), rkey.data_ptr(), best.data_ptr(),
        _stream(best),
    )
    return best


@_on_device
def greedy_cleanup(cand_provider, cand_cost, owner, p4t, open_idx):
    """K9 (``csrc/cleanup.cu``): the open tasks ``open_idx`` (ascending) in
    order each take their cheapest still-free candidate. Returns the new
    p4t [T] i32 (the input is not changed)."""
    T, K = cand_cost.shape
    dev = cand_cost.device
    P = owner.shape[0]
    cand_p = cand_provider.to(torch.int32).contiguous()
    cand_c = cand_cost.to(torch.float32).contiguous()
    owner = owner.to(torch.int32).contiguous()
    open_idx = open_idx.to(torch.int32).contiguous()
    out = p4t.to(torch.int32).clone()
    for t in (cand_p, owner, open_idx, out):
        if t.device != dev:
            raise ValueError(f"K9: every input must lie on {dev}, got {t.device}")
    if cand_p.shape != (T, K) or out.shape != (T,) or K > 128 or P > 1_638_400:
        raise ValueError(f"K9 takes [T, K <= 128] candidates and P <= 1,638,400, got {K}, {P}")
    _launch("greedy_cleanup", _lib("cleanup").k9_greedy_cleanup,
        cand_p.data_ptr(), cand_c.data_ptr(), K, P, owner.data_ptr(), open_idx.data_ptr(),
        open_idx.numel(), out.data_ptr(), _stream(out),
    )
    return out


@_on_device
def cost_block(ep, er, weights):
    """K10 (``csrc/candidates.cu``, a list launch of K1's layout): the
    unjittered cost of every cell, INFEASIBLE off the mask, slot-major:
    cost [T, P] f32 (``cost_matrix(ep, er, weights)[0].T``)."""
    if ep.num < 1 or er.num < 1:
        raise ValueError("K10 takes at least one provider and one task")
    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    cost = torch.empty((T, P), dtype=torch.float32, device=dev)
    _launch("cost_block", _lib("candidates").k10_cost_block,
        pcols, rcols, P, T, K, W, *w, aux.data_ptr(), cost.data_ptr(), _stream(cost),
    )
    return cost


# K11's layout (csrc/binpack.cu: k11_layout), mirrored so that the route
# is chosen from the shapes without a card: a ring of up to K11_MAX_SLOTS
# slots of up to K11_CHUNK_MAX cost floats in K11_SMEM_MAX bytes of shared
# memory, beside the chain's state in the shared instantiation
K11_SMEM_MAX = 232_448
K11_CHUNK_MAX = 32 * 480
K11_MAX_SLOTS, K11_MIN_SLOTS = 32, 2
K11_HDR_BYTES = 48
K11_FIXED_BYTES = 64 + 15 * 160 * 8 + 128  # the pick's keys, the consumer warps' queues
K11_ROUTES = {"shared": "binpack_ffd", "device": "binpack_ffd_device"}  # -> LAUNCHES key


def _round16(x: int) -> int:
    return (x + 15) & ~15


def binpack_slots(P: int, R: int, L: int, G: int, shared_state: bool) -> int:
    """The ring's slot count of K11's pack launch for these shapes, in the
    shared instantiation (capacity, domains and occupancy bitmask in shared
    memory) or the device one; 0 where it does not fit."""
    C = min(P, K11_CHUNK_MAX)
    slot = _round16(C * 4 + 12)
    state = _round16(R * P * 4 + P * 4 + (L * G + 31) // 32 * 4) if shared_state else 0
    room = K11_SMEM_MAX - K11_FIXED_BYTES - state
    S = min(K11_MAX_SLOTS, room // (slot + 16 + K11_HDR_BYTES)) if room > 0 else 0
    return S if S >= K11_MIN_SLOTS else 0


def binpack_route(P: int, R: int, L: int, G: int) -> str:
    """K11's instantiation for P providers, R resources and L x G
    occupancy bits, from the shapes alone: "shared" where the chain's state
    fits in the block's shared memory beside a ring of two slots, else
    "device" (the state in device memory)."""
    return "shared" if binpack_slots(P, R, L, G, True) else "device"


@_on_device
def binpack_ffd(cost_tp, demand, capacity, task_order, anti_group, loc_id, L: int, G: int,
                route: str | None = None):
    """K11 (``csrc/binpack.cu``): the FFD vector bin-pack over the slot-major
    cost ``cost_tp`` [T, P]; ``task_order`` None = the FFD demand order,
    ranked in the launch. ``route`` forces an instantiation (default
    :func:`binpack_route`'s); one that does not fit raises. Returns
    (provider_for_task [T] i32, remaining capacity [P, R] f32)."""
    T, P = cost_tp.shape
    dev = cost_tp.device
    R = demand.shape[1] if demand.dim() == 2 else 0
    cost_tp = cost_tp.to(torch.float32).contiguous()
    demand = demand.to(torch.float32).contiguous()
    cap = capacity.to(torch.float32).clone().contiguous()
    group = anti_group.to(torch.int32).contiguous()
    loc = loc_id.to(torch.int32).contiguous()
    if T < 1 or P < 1 or not 1 <= R <= 8 or demand.shape != (T, R) or cap.shape != (P, R):
        raise ValueError(f"K11 takes cost [T, P], demand [T, R <= 8] and capacity [P, R], "
                         f"got {tuple(cost_tp.shape)}, {tuple(demand.shape)}, {tuple(cap.shape)}")
    if group.shape != (T,) or loc.shape != (P,) or L < 1 or G < 1:
        raise ValueError("K11: anti_group must be [T] and loc_id [P], with L, G >= 1")
    order = None if task_order is None else task_order.to(torch.int32).contiguous()
    if order is not None and order.shape != (T,):
        raise ValueError(f"K11: task_order must be a [{T}] tensor on {dev}")
    for t in (demand, cap, group, loc) + (() if order is None else (order,)):
        if t.device != dev:
            raise ValueError(f"K11: every input must lie on {dev}, got {t.device}")
    route = binpack_route(P, R, L, G) if route is None else route
    if route not in K11_ROUTES or not binpack_slots(P, R, L, G, route == "shared"):
        raise ValueError(f"K11: no {route!r} instantiation at P={P}, R={R}, L x G={L * G}")
    # the range checks in one read-back
    ends = [group.min(), group.max(), loc.min(), loc.max()]
    if order is not None:
        ends += [order.min(), order.max()]
    lo_g, hi_g, lo_l, hi_l, *o = torch.stack(ends).tolist()
    if lo_g < -1 or hi_g >= G or lo_l < 0 or hi_l >= L:
        raise ValueError(f"K11: anti_group must lie in [-1, {G}) and loc_id in [0, {L})")
    if o and (o[0] < 0 or o[1] >= T):
        raise ValueError(f"K11: task_order ids out of range [0, {T})")
    if order is None:
        order = torch.empty(T, dtype=torch.int32, device=dev)
    shared = route == "shared"
    used = (None if shared
            else torch.zeros((L * G + 31) // 32, dtype=torch.int32, device=dev))
    pft = torch.empty(T, dtype=torch.int32, device=dev)
    _launch(K11_ROUTES[route], _lib("binpack").k11_binpack_ffd,
        cost_tp.data_ptr(), P, T, demand.data_ptr(), R, order.data_ptr(),
        int(task_order is not None), group.data_ptr(), loc.data_ptr(), L, G, cap.data_ptr(),
        None if used is None else used.data_ptr(), pft.data_ptr(), int(shared), _stream(pft),
    )
    return pft, cap


@_on_device
def greedy_assign(cost_tp, task_order):
    """K12 (``csrc/greedy.cu``): the sequential greedy over the slot-major
    cost ``cost_tp`` [T, P], tasks in ``task_order`` (ids in [0, T)):
    producer warps reduce each coming row to a short sorted list, one warp
    takes a step a ballot. Returns provider_for_task [T] i32 (-1 for a
    task not visited or left unassigned)."""
    T, P = cost_tp.shape
    dev = cost_tp.device
    if cost_tp.dtype != torch.float32 or not cost_tp.is_contiguous() or T < 1 or P < 1:
        raise ValueError("K12: cost_tp must be a non-empty contiguous f32 [T, P] tensor")
    if P > 1_638_400:
        raise ValueError(f"K12 takes P <= 1,638,400 providers, got {P}")
    order = task_order.to(torch.int32).contiguous()
    if order.device != dev or order.dim() != 1:
        raise ValueError(f"K12: task_order must be a 1-d tensor on {dev}")
    if order.numel() and (int(order.min()) < 0 or int(order.max()) >= T):
        raise ValueError(f"K12: task ids out of range [0, {T})")
    if cost_tp.data_ptr() % 16:  # the rows are read from their 16-byte granules
        cost_tp = cost_tp.clone()
    p4t = torch.full((T,), -1, dtype=torch.int32, device=dev)
    _launch("greedy_assign", _lib("greedy").k12_greedy,
        cost_tp.data_ptr(), T, P, order.data_ptr(), order.numel(), p4t.data_ptr(), _stream(p4t),
    )
    return p4t


# K13 (csrc/sinkhorn.cu): its rounds run over the feasible cells packed
# with 16-bit columns, or over dense rows where at least K13_DENSE_SHARE of
# the cells are feasible or a side has more than K13_PACKED_COLS columns (a
# mirror of the library's dense_of, k13_dense_layout)
K13_DENSE_SHARE = (4, 7)
K13_PACKED_COLS = 65536


def sinkhorn_layout(n_feasible: int, T: int, P: int) -> str:
    """The layout of K13's rounds on a [T, P] cost with ``n_feasible``
    cells below INFEASIBLE/2: "dense" or "packed"."""
    num, den = K13_DENSE_SHARE
    wide = T > K13_PACKED_COLS or P > K13_PACKED_COLS
    return "dense" if wide or n_feasible * den >= T * P * num else "packed"


@_on_device
def sinkhorn(cost_tp, eps: float, num_iters: int):
    """K13 (``csrc/sinkhorn.cu``): the log-domain Sinkhorn over the
    slot-major cost ``cost_tp`` [T, P], its rounds over the feasible cells
    in both orientations. Returns (plan [T, P] with subnormal entries
    flushed to +0, the rounding cost [T, P] = where(feasible, -plan,
    INFEASIBLE), each task's largest plan entry [T], u [P], v [T]), all
    f32."""
    T, P = cost_tp.shape
    dev = cost_tp.device
    if cost_tp.dtype != torch.float32 or not cost_tp.is_contiguous() or T < 1 or P < 1:
        raise ValueError("K13: cost_tp must be a non-empty contiguous f32 [T, P] tensor")
    if not eps > 0 or num_iters < 0:
        raise ValueError(f"K13 takes eps > 0 and num_iters >= 0, got {eps}, {num_iters}")
    wt, wp = (T + 31) // 32, (P + 31) // 32
    t4, p4 = (T + 3) // 4 * 4, (P + 3) // 4 * 4
    i32, f32 = torch.int32, torch.float32
    # each side's bitmap, word places, row places and feasible cells; its
    # values (a dense row padded to 4) lie over the plan (providers' rows)
    # and the rounding cost (tasks'), their columns beside
    pbits = torch.empty((P, wt), dtype=i32, device=dev)
    pwpre = torch.empty((P, wt), dtype=i32, device=dev)
    tbits = torch.empty((T, wp), dtype=i32, device=dev)
    twpre = torch.empty((T, wp), dtype=i32, device=dev)
    poff = torch.empty(P, dtype=torch.int64, device=dev)
    toff = torch.empty(T, dtype=torch.int64, device=dev)
    pcnt = torch.empty(P, dtype=i32, device=dev)
    tcnt = torch.empty(T, dtype=i32, device=dev)
    plan = torch.empty(P * t4, dtype=f32, device=dev)
    rcost = torch.empty(T * p4, dtype=f32, device=dev)
    pcidx = torch.empty(plan.numel(), dtype=torch.int16, device=dev)
    tcidx = torch.empty(rcost.numel(), dtype=torch.int16, device=dev)
    colmax = torch.empty(T, dtype=f32, device=dev)
    u = torch.empty(p4, dtype=f32, device=dev)  # padded to a dense row's columns
    v = torch.empty(t4, dtype=f32, device=dev)
    ctl = torch.zeros(6, dtype=i32, device=dev)  # barrier, feasible rows a side, row counters
    alloc = torch.zeros(3, dtype=torch.int64, device=dev)  # packed values a side, feasible cells
    _launch("sinkhorn", _lib("sinkhorn").k13_sinkhorn,
        cost_tp.data_ptr(), T, P, eps, num_iters, pbits.data_ptr(), pwpre.data_ptr(),
        poff.data_ptr(), pcnt.data_ptr(), pcidx.data_ptr(), tbits.data_ptr(), twpre.data_ptr(),
        toff.data_ptr(), tcnt.data_ptr(), tcidx.data_ptr(), plan.data_ptr(), rcost.data_ptr(),
        colmax.data_ptr(), u.data_ptr(), v.data_ptr(), ctl.data_ptr(), alloc.data_ptr(),
        _stream(plan),
    )
    return plan[:T * P].view(T, P), rcost[:T * P].view(T, P), colmax, u[:P], v[:T]


@_on_device
def blocked_feasibility(ep, er, weights):
    """K14, feasibility launch (``csrc/blocked.cu``): the mask of cells with
    cost < INFEASIBLE/2. Returns (row_any [P] bool, col_any [T] bool, bits),
    ``bits`` the mask as an ``ops.blocked.FeasibilityBits`` (row-major [P,
    ceil(T/32)] and column-major [T, ceil(P/32)] u32 words, 4 x (P x
    ceil(T/32) + T x ceil(P/32)) bytes), which the solve's passes read."""
    from protocol_tpu_torch.ops.blocked import FeasibilityBits

    dev, pcols, rcols, (P, T, K, W), w, aux = _k1_setup(ep, er, weights)
    if P < 1 or T < 1:
        raise ValueError(f"K14 takes P, T >= 1, got P={P}, T={T}")
    any_bits = torch.zeros((P + 31) // 32 + (T + 31) // 32, dtype=torch.int32, device=dev)
    row_bits, col_bits = any_bits[:(P + 31) // 32], any_bits[(P + 31) // 32:]
    bits = FeasibilityBits.empty(P, T, dev)
    _launch("blocked_feasibility", _lib("blocked").k14_feasibility,
        pcols, rcols, P, T, K, W, *w, aux.data_ptr(), row_bits.data_ptr(), col_bits.data_ptr(),
        bits.rows.data_ptr(), bits.cols.data_ptr(), _stream(any_bits),
    )
    return _bit_set(row_bits, P), _bit_set(col_bits, T), bits


def _bit_set(words: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool: bit i % 32 of words[i // 32]."""
    i = torch.arange(n, dtype=torch.int64, device=words.device)
    return ((words[i >> 5] >> (i & 31).to(torch.int32)) & 1).bool()


def _blocked_setup(ep, er, weights, eps: float, pot: torch.Tensor, bits, rows: bool, name: str):
    """A pass's checked arguments: the columns, the potential, aux (the
    prep terms, then the packed rows at csrc/blocked.cu's pack_offset and
    the row counter) and the words of ``bits`` it reads."""
    P, T = ep.num, er.num
    aux_floats = -(-2 * (P + T) // 4) * 4 + 4 * (P + T) + 1
    dev, pcols, rcols, _, w, aux = _k1_setup(ep, er, weights, aux_floats)
    n_pot = T if rows else P
    if pot.device != dev or pot.dtype != torch.float32 or pot.shape != (n_pot,):
        raise ValueError(f"{name}: the potential must be a [{n_pot}] f32 tensor on {dev}")
    if not eps > 0 or P < 1 or T < 1:
        raise ValueError(f"{name} takes eps > 0 and P, T >= 1, got {eps}, {P}, {T}")
    bits.check(P, T, dev, name)
    words = bits.rows if rows else bits.cols
    return dev, pcols, rcols, (P, T), w, aux, pot.contiguous(), words


def _blocked_lse(ep, er, weights, eps: float, pot: torch.Tensor, bits, rows: bool, name: str):
    dev, pcols, rcols, (P, T), w, aux, pot, words = _blocked_setup(ep, er, weights, eps, pot,
                                                                   bits, rows, name)
    lse = torch.empty(P if rows else T, dtype=torch.float32, device=dev)
    _launch(name, _lib("blocked").k14_lse,
        pcols, rcols, P, T, *w, eps, int(rows), pot.data_ptr(), aux.data_ptr(),
        words.data_ptr(), lse.data_ptr(), _stream(lse),
    )
    return lse


@_on_device
def blocked_row_lse(ep, er, weights, eps: float, v: torch.Tensor, bits):
    """K14, row pass (``csrc/blocked.cu``): per provider, the logsumexp
    over its feasible tasks (``bits``, the solve's FeasibilityBits, read
    row-major) of K[p, t] + v[t], K = -cost/eps; a provider without one
    gets -inf. Returns [P] f32."""
    return _blocked_lse(ep, er, weights, eps, v, bits, True, "blocked_row_lse")


@_on_device
def blocked_col_lse(ep, er, weights, eps: float, u: torch.Tensor, bits):
    """K14, column pass (``csrc/blocked.cu``): per task, the logsumexp over
    its feasible providers (``bits`` read column-major) of K[p, t] + u[p];
    a task without one gets -inf. Returns [T] f32."""
    return _blocked_lse(ep, er, weights, eps, u, bits, False, "blocked_col_lse")


@_on_device
def blocked_col_partial(ep_local, er, weights, eps: float, u_local: torch.Tensor, bits):
    """K14, column pass in its partial mode (``csrc/blocked.cu``): per task,
    the online (max, sum-exp) pair of K[p, t] + u_local[p] over its
    feasible providers among those of ``ep_local`` (one shard's rows;
    ``bits`` the shard's FeasibilityBits, read column-major). Returns (m
    [T], s [T]) f32, with m = -inf and s = 0 where a task has no feasible
    cell among them."""
    dev, pcols, rcols, (P, T), w, aux, u_local, words = _blocked_setup(
        ep_local, er, weights, eps, u_local, bits, False, "blocked_col_partial")
    m = torch.empty(T, dtype=torch.float32, device=dev)
    s = torch.empty(T, dtype=torch.float32, device=dev)
    _launch("blocked_col_partial", _lib("blocked").k14_col_partial,
        pcols, rcols, P, T, *w, eps, u_local.data_ptr(), aux.data_ptr(), words.data_ptr(),
        m.data_ptr(), s.data_ptr(), _stream(m),
    )
    return m, s


@_on_device
def pair_cost(ep, er, weights, p4t: torch.Tensor):
    """K15 (``csrc/blocked.cu``, one launch): per task t, the unjittered
    cost of the cell (p4t[t], t), INFEASIBLE where p4t[t] < 0. Returns [T]
    f32. A provider id at or above P raises before the launch (one read
    of max(p4t) back to the host)."""
    dev, pcols, rcols, (P, T, K, W), w, _ = _k1_setup(ep, er, weights, aux_floats=0)
    if p4t.device != dev or p4t.dim() != 1 or p4t.shape[0] != T or P < 1 or T < 1:
        raise ValueError(f"pair_cost: p4t must be a [{T}] tensor on {dev}")
    p4t = p4t.to(torch.int32).contiguous()
    if int(p4t.max()) >= P:
        raise ValueError(f"pair_cost: provider ids out of range [-1, {P})")
    out = torch.empty(T, dtype=torch.float32, device=dev)
    _launch("pair_cost", _lib("blocked").k15_pair_cost,
        pcols, rcols, P, T, K, W, *w, p4t.data_ptr(), out.data_ptr(), _stream(out),
    )
    return out


# rounds the mesh's auctions (K16's segments, K17's rounds) enqueue between
# two reads of their loop's go flag: every launch after the stop does
# nothing, so a segment costs one read-back
CARD_CHECK_EVERY = 256


# K16's per-shard int32 state, one word each, and its size MESH_CTL: the
# loop's it, best and stall, whether this round runs (go) and has counts
# to fold (pending), the frontier size nb, the frontier rows bid so far,
# and the shard's open and assigned counts. A mirror of the Ctl enum in
# csrc/auction.cuh.
(CTL_IT, CTL_BEST, CTL_STALL, CTL_GO, CTL_PENDING, CTL_NB, CTL_ROWS, CTL_OPEN, CTL_ASSIGNED,
 MESH_CTL) = range(10)


def _mesh_tensors(dev, what: str, **named) -> None:
    for name, (t, dtype, n) in named.items():
        if t.device != dev or t.dtype != dtype or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor of {n} "
                             f"elements on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


# K16's segment launch (csrc/auction.cu): the shards one launch takes, and
# the bytes its open bitmask may hold (D ceil(Tl / 32) words); a mirror of
# kMaxShards and kMaxOpenBytes in csrc/auction.cuh
MESH_SEGMENT_MAX_SHARDS = 32
MESH_SEGMENT_OPEN_BYTES = 200 * 1024


def mesh_segment_fits(D: int, Tl: int, K: int, B: int) -> bool:
    """Whether K16's segment launch takes D shards of Tl rows, K candidates
    a row and a per-shard frontier of B (decided from the shapes alone)."""
    return (1 <= D <= MESH_SEGMENT_MAX_SHARDS and 1 <= K <= 128 and 1 <= B <= Tl
            and D * -(-Tl // 32) * 4 <= MESH_SEGMENT_OPEN_BYTES)


@_on_device
def mesh_segment(cand_safe, value_base, feasible, give_up, price, owner, p4t, retired, ctl,
                 eps: float, B: int, max_iters: int, stall_limit: int, fresh: bool,
                 cluster: int | None = None) -> None:
    """K16's segment launch (``csrc/auction.cu``, K2's kernel over D shards):
    up to :data:`CARD_CHECK_EVERY` rounds of the sharded phase's
    ``max_iters`` for every shard of a mesh of views of one card, in one
    launch of one thread-block cluster of ``cluster`` blocks (default
    :func:`k2_cluster`; a size the card refuses raises). Takes the stacked
    shard fields: ``cand_safe`` / ``value_base`` [D, Tl, K], ``feasible`` /
    ``p4t`` / ``retired`` [D, Tl], ``give_up`` [D, 1], ``price`` / ``owner``
    [D, P] (the replicas), ``ctl`` [D, MESH_CTL]. With ``fresh`` the loop
    state starts afresh (it, stall and the frontier rows 0, best the
    assigned count), else it goes on from ``ctl``'s. Updates price, owner,
    p4t, retired and ctl in place; ``ctl``'s go word says whether rounds
    are left."""
    D, Tl, K = value_base.shape
    P = price.shape[-1]
    dev = value_base.device
    if not mesh_segment_fits(D, Tl, K, B):
        raise ValueError(f"K16's segment launch takes D <= {MESH_SEGMENT_MAX_SHARDS}, K <= 128, "
                         f"1 <= B <= Tl and D ceil(Tl / 32) words of open bits <= "
                         f"{MESH_SEGMENT_OPEN_BYTES} bytes; got D={D}, Tl={Tl}, K={K}, B={B}")
    _mesh_tensors(dev, "mesh_segment", cand_safe=(cand_safe, torch.int32, D * Tl * K),
                  value_base=(value_base, torch.float32, D * Tl * K),
                  feasible=(feasible, torch.uint8, D * Tl), give_up=(give_up, torch.float32, D),
                  price=(price, torch.float32, D * P), owner=(owner, torch.int32, D * P),
                  p4t=(p4t, torch.int32, D * Tl), retired=(retired, torch.uint8, D * Tl),
                  ctl=(ctl, torch.int32, D * MESH_CTL))
    C = k2_cluster(dev) if cluster is None else int(cluster)
    f_idx, fr_p1, fr_key, win_key = _phase_scratch(D * B, P, dev)
    _launch("mesh_segment", _lib("auction").k16_mesh_segment,
        cand_safe.data_ptr(), value_base.data_ptr(), feasible.data_ptr(), give_up.data_ptr(),
        D, Tl, K, B, P, max_iters, stall_limit, CARD_CHECK_EVERY, int(bool(fresh)), eps,
        price.data_ptr(), owner.data_ptr(), p4t.data_ptr(), retired.data_ptr(), f_idx.data_ptr(), fr_p1.data_ptr(), fr_key.data_ptr(),
        win_key.data_ptr(), ctl.data_ptr(), C, _stream(ctl), what=f"mesh_segment (cluster of {C})",
    )


@_on_device
def mesh_round_bid(cand_safe, value_base, feasible, give_up, price, retired, p4t, tot, ctl,
                   front, front_bid, win_key, eps: float, B: int, max_iters: int,
                   stall_limit: int) -> None:
    """K16, the bid step of one shard's round (``csrc/mesh_auction.cu``): the
    loop control from the combined counts ``tot`` [2], the frontier of the
    first B open rows, its bids, retirement, and the scatter-max of the
    bids into ``win_key`` [P] (order-preserving int32 keys). Updates
    ``ctl``, ``retired``, ``front``, ``front_bid`` and ``win_key`` in place."""
    Tl, K = value_base.shape
    P = price.shape[0]
    dev = value_base.device
    if not 1 <= B <= Tl or K > 128:
        raise ValueError(f"K16 takes 1 <= B <= Tl and K <= 128, got B={B}, Tl={Tl}, K={K}")
    _mesh_tensors(dev, "mesh_round_bid", cand_safe=(cand_safe, torch.int32, Tl * K),
                  value_base=(value_base, torch.float32, Tl * K),
                  feasible=(feasible, torch.uint8, Tl), give_up=(give_up, torch.float32, 1),
                  price=(price, torch.float32, P), retired=(retired, torch.uint8, Tl),
                  p4t=(p4t, torch.int32, Tl), tot=(tot, torch.int32, 2),
                  ctl=(ctl, torch.int32, MESH_CTL), front=(front, torch.int32, 2 * B),
                  front_bid=(front_bid, torch.float32, B), win_key=(win_key, torch.int32, P))
    _launch("mesh_round_bid", _lib("mesh_auction").k16_round_bid,
        cand_safe.data_ptr(), value_base.data_ptr(), feasible.data_ptr(), give_up.data_ptr(),
        Tl, K, B, max_iters, stall_limit, eps, price.data_ptr(), retired.data_ptr(),
        p4t.data_ptr(), tot.data_ptr(), ctl.data_ptr(), front.data_ptr(), front_bid.data_ptr(),
        win_key.data_ptr(), _stream(ctl),
    )


@_on_device
def mesh_round_resolve(ctl, front, front_bid, win_key, win_task, offset: int) -> None:
    """K16, the resolve step: each bid equal to its provider's combined best
    ``win_key`` [P] writes its global task id (``offset`` + row) into
    ``win_task`` [P] by atomicMin, in place."""
    dev = ctl.device
    B = front_bid.numel()
    P = win_key.numel()
    _mesh_tensors(dev, "mesh_round_resolve", ctl=(ctl, torch.int32, MESH_CTL),
                  front=(front, torch.int32, 2 * B), front_bid=(front_bid, torch.float32, B),
                  win_key=(win_key, torch.int32, P), win_task=(win_task, torch.int32, P))
    _launch("mesh_round_resolve", _lib("mesh_auction").k16_round_resolve,
        B, offset, ctl.data_ptr(), front.data_ptr(), front_bid.data_ptr(), win_key.data_ptr(),
        win_task.data_ptr(), _stream(ctl),
    )


@_on_device
def mesh_round_apply(win_key, win_task, feasible, retired, ctl, price, owner, p4t, key_local,
                     task_local, offset: int, T: int) -> None:
    """K16, the apply step: per provider with a combined winner, the
    eviction and the seat on the shard's rows [offset, offset + Tl), the
    replica's owner and price, the shard's counts in ``ctl``; resets the
    shard's ``key_local`` / ``task_local`` [P]. In place."""
    dev = ctl.device
    P = price.numel()
    Tl = p4t.numel()
    _mesh_tensors(dev, "mesh_round_apply", win_key=(win_key, torch.int32, P),
                  win_task=(win_task, torch.int32, P), feasible=(feasible, torch.uint8, Tl),
                  retired=(retired, torch.uint8, Tl), ctl=(ctl, torch.int32, MESH_CTL),
                  price=(price, torch.float32, P), owner=(owner, torch.int32, P),
                  p4t=(p4t, torch.int32, Tl), key_local=(key_local, torch.int32, P),
                  task_local=(task_local, torch.int32, P))
    _launch("mesh_round_apply", _lib("mesh_auction").k16_round_apply,
        P, T, Tl, offset, win_key.data_ptr(), win_task.data_ptr(), feasible.data_ptr(),
        retired.data_ptr(), ctl.data_ptr(), price.data_ptr(), owner.data_ptr(), p4t.data_ptr(),
        key_local.data_ptr(), task_local.data_ptr(), _stream(ctl),
    )


# K17's loop state, int64 words on the mesh's first device (a copy on each
# shard's): the round count, whether the next round runs (go), the open
# tasks and the open rows summed over the rounds, and its size DENSE_CTL.
# The one definition of the layout: csrc/mesh_dense.cu's Ctl enum follows
# it.
DCTL_IT, DCTL_GO, DCTL_OPEN, DCTL_ROWS, DENSE_CTL = range(5)


@_on_device
def mesh_dense_scan(value_base, price, p4t, feasible, ctl, scan, delta, offset: int) -> None:
    """K17, one shard's scan (``csrc/mesh_dense.cu``): for each open task
    (p4t < 0, feasible) the best value v1 over the shard's row of
    ``value_base`` [T, Pl] minus ``price`` [Pl] at the first maximum p1, v2
    with only p1 masked, the global p1 (``offset`` + p1, -1 where v1 <=
    -5e17) and price[p1], into ``scan`` [4, T] (row 2 as int32 bits);
    ``delta`` [T] is reset to -2. In place."""
    T, Pl = value_base.shape
    _mesh_tensors(value_base.device, "mesh_dense_scan",
                  value_base=(value_base, torch.float32, T * Pl), price=(price, torch.float32, Pl),
                  p4t=(p4t, torch.int32, T), feasible=(feasible, torch.uint8, T),
                  ctl=(ctl, torch.int64, DENSE_CTL), scan=(scan, torch.float32, 4 * T),
                  delta=(delta, torch.int32, T))
    _launch("mesh_dense_scan", _lib("mesh_dense").k17_scan,
        value_base.data_ptr(), price.data_ptr(), p4t.data_ptr(), feasible.data_ptr(),
        ctl.data_ptr(), T, Pl, offset, scan.data_ptr(), delta.data_ptr(), _stream(scan),
    )


@_on_device
def mesh_dense_combine(gathered, p4t, feasible, ctl, eps: float, bt) -> None:
    """K17, the combine on the mesh's first device: from the shards' scan
    buffers ``gathered`` [D, 4, T], per open task the best shard (the first
    maximum of v1), the runner-up over the rest floored at -1e8, and the
    bid (price1 + (v1 - v2)) + eps with its global target, into ``bt``
    [2, T] (row 1 as int32 bits, -1 where the task does not bid). In place."""
    D = gathered.shape[0]
    T = p4t.numel()
    _mesh_tensors(gathered.device, "mesh_dense_combine",
                  gathered=(gathered, torch.float32, D * 4 * T), p4t=(p4t, torch.int32, T),
                  feasible=(feasible, torch.uint8, T), ctl=(ctl, torch.int64, DENSE_CTL),
                  bt=(bt, torch.float32, 2 * T))
    _launch("mesh_dense_combine", _lib("mesh_dense").k17_combine,
        gathered.data_ptr(), p4t.data_ptr(), feasible.data_ptr(), ctl.data_ptr(), D, T, eps,
        bt.data_ptr(), _stream(bt),
    )


@_on_device
def mesh_dense_resolve(bt, ctl, win_key, offset: int) -> None:
    """K17, one shard's resolve: each bid of ``bt`` [2, T] whose target lies
    in [offset, offset + Pl) scatter-maxes (order-preserving bid bits << 32
    | ~task) into ``win_key`` [Pl] (int64 bits; 0 = no bid). In place."""
    T = bt.numel() // 2
    Pl = win_key.numel()
    _mesh_tensors(bt.device, "mesh_dense_resolve", bt=(bt, torch.float32, 2 * T),
                  ctl=(ctl, torch.int64, DENSE_CTL), win_key=(win_key, torch.int64, Pl))
    _launch("mesh_dense_resolve", _lib("mesh_dense").k17_resolve,
        bt.data_ptr(), ctl.data_ptr(), T, Pl, offset, win_key.data_ptr(), _stream(win_key),
    )


@_on_device
def mesh_dense_apply(win_key, ctl, price, owner, delta, offset: int) -> None:
    """K17, one shard's apply: each provider with a key evicts its owner
    (delta -1), seats the winner (delta = its global id ``offset`` + p),
    takes the bid as its price and resets its key. In place."""
    Pl = win_key.numel()
    T = delta.numel()
    _mesh_tensors(win_key.device, "mesh_dense_apply", win_key=(win_key, torch.int64, Pl),
                  ctl=(ctl, torch.int64, DENSE_CTL), price=(price, torch.float32, Pl),
                  owner=(owner, torch.int32, Pl), delta=(delta, torch.int32, T))
    _launch("mesh_dense_apply", _lib("mesh_dense").k17_apply,
        win_key.data_ptr(), ctl.data_ptr(), Pl, offset, price.data_ptr(), owner.data_ptr(),
        delta.data_ptr(), _stream(delta),
    )


@_on_device
def mesh_dense_finish(deltas, feasible, ctl, p4t, max_iters: int) -> None:
    """K17, the end of a round on the mesh's first device: the max of the
    shards' ``deltas`` [D, T] applied to ``p4t`` where it is > -2, then the
    loop state (round count, open tasks, open rows, go). In place."""
    D, T = deltas.shape
    _mesh_tensors(deltas.device, "mesh_dense_finish", deltas=(deltas, torch.int32, D * T),
                  feasible=(feasible, torch.uint8, T), ctl=(ctl, torch.int64, DENSE_CTL),
                  p4t=(p4t, torch.int32, T))
    _launch("mesh_dense_finish", _lib("mesh_dense").k17_finish,
        deltas.data_ptr(), feasible.data_ptr(), ctl.data_ptr(), D, T, max_iters, p4t.data_ptr(),
        _stream(p4t),
    )
