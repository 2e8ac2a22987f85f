"""The port's encoded columns, capability mask, tie jitter, cost and
synthetic generators, held against the JAX reference on the same numpy
inputs (protocol_tpu_torch vs protocol_tpu)."""

import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from protocol_tpu.models.node import ComputeRequirements, ComputeSpecs, CpuSpecs, GpuSpecs
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.cost import cost_matrix as j_cost_matrix
from protocol_tpu.ops.cost import tie_jitter as j_tie_jitter
from protocol_tpu.ops.cost import tie_jitter_ids as j_tie_jitter_ids
from protocol_tpu.ops.encoding import FeatureEncoder
from protocol_tpu.ops.encoding import compat_mask as j_compat_mask
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch.ops.cost import CostWeights, cost_matrix, tie_jitter, tie_jitter_ids
from protocol_tpu_torch.ops.encoding import (
    compat_mask,
    providers_from_numpy,
    requirements_from_numpy,
)
from protocol_tpu_torch.trace import synth as t_synth

from tests.test_encoding import random_requirements, random_specs

# haversine tolerance: sin/cos/asin differ by a few ulps between XLA's and
# torch's CPU libraries, and asin near 1 (antipodal pairs) amplifies an
# ulp of its argument; at 0.001/km over distances < 20,000 km the cost
# moves by well under 1e-3 (measured max 5e-5 at 512x512)
COST_ATOL = 1e-3


def to_port(ep, er, device="cpu"):
    """The port's columns from the reference's encoded columns."""
    return providers_from_numpy(ep, device), requirements_from_numpy(er, device)


def encode_random(seed, P, T):
    rng = random.Random(seed)
    enc = FeatureEncoder()
    ep = enc.encode_providers([random_specs(rng) for _ in range(P)])
    er = enc.encode_requirements([random_requirements(rng) for _ in range(T)])
    return ep, er


def encode_wide_vocab(P=96, T=40, seed=0):
    """A vocabulary of 40 model classes (ids up to 39: the second mask
    word), 4 GPU options per requirement, and absent specs on both sides."""
    rng = random.Random(seed)
    enc = FeatureEncoder()
    names = [f"ACME-X{i:02d}" for i in range(40)]
    specs = []
    for i in range(P):
        if i % 11 == 5 and i >= 40:
            specs.append(None)  # no specs at all
            continue
        gpu = GpuSpecs(
            count=rng.choice([None, 1, 2, 8]),
            model=names[i % 40] if i < 40 or i % 7 else None,
            memory_mb=rng.choice([None, 24000, 80000]),
        )
        specs.append(ComputeSpecs(
            gpu=gpu if i < 40 or i % 5 else None,
            cpu=CpuSpecs(cores=rng.choice([None, 8, 32])) if i % 3 else None,
            ram_mb=rng.choice([None, 65536]),
            storage_gb=rng.choice([None, 1000]),
        ))
    reqs = []
    for j in range(T):
        opts = ";".join(
            f"gpu:count={rng.choice([1, 2, 8])};gpu:model={names[(j * 3 + o * 17) % 40]}"
            for o in range(j % 5)
        )
        dsl = opts if opts else "ram_mb=1024" if j % 2 else ""
        reqs.append(ComputeRequirements.parse(dsl) if dsl else ComputeRequirements())
    ep = enc.encode_providers(specs)
    er = enc.encode_requirements(reqs)
    return ep, er


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compat_mask_exact(seed):
    ep, er = encode_random(seed, 40, 60)
    tp, tr = to_port(ep, er)
    np.testing.assert_array_equal(compat_mask(tp, tr).numpy(), np.asarray(j_compat_mask(ep, er)))


def test_compat_mask_wide_vocab_and_four_options():
    ep, er = encode_wide_vocab()
    assert er.gpu_opt_valid.shape[1] == 4
    assert int(np.asarray(ep.gpu_model_id).max()) >= 32
    tp, tr = to_port(ep, er)
    ref = np.asarray(j_compat_mask(ep, er))
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(compat_mask(tp, tr).numpy(), ref)


def test_compat_mask_absent_specs_and_padding():
    enc = FeatureEncoder()
    ep = enc.encode_providers([None, ComputeSpecs()], pad_to=4)
    er = enc.encode_requirements(
        [ComputeRequirements(), ComputeRequirements.parse("ram_mb=1")], pad_to=3
    )
    tp, tr = to_port(ep, er)
    np.testing.assert_array_equal(compat_mask(tp, tr).numpy(), np.asarray(j_compat_mask(ep, er)))


@pytest.mark.parametrize("P,T,po,to", [(64, 48, 0, 0), (33, 17, 5, 1 << 31), (8, 9, 3, 70000)])
def test_tie_jitter_bit_exact(P, T, po, to):
    ref = np.asarray(j_tie_jitter(P, T, provider_offset=po, task_offset=to))
    got = tie_jitter(P, T, provider_offset=po, task_offset=to).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_tie_jitter_ids_bit_exact():
    rng = np.random.default_rng(0)
    p_ids = rng.integers(0, 2**31, 37).astype(np.int32)
    t_ids = rng.integers(0, 2**31, 23).astype(np.int32)
    ref = np.asarray(j_tie_jitter_ids(p_ids, t_ids))
    got = tie_jitter_ids(torch.from_numpy(p_ids), torch.from_numpy(t_ids)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3])
def test_cost_matrix_within_haversine_tolerance(seed):
    ep, er = encode_random(seed, 48, 40)
    # encoded marketplaces carry no coordinates: give every row one
    rng = np.random.default_rng(seed)
    for enc, n in ((ep, 48), (er, 40)):
        enc.lat = np.radians(rng.uniform(-80, 80, n)).astype(np.float32)
        enc.lon = np.radians(rng.uniform(-180, 180, n)).astype(np.float32)
        enc.has_location = np.ones(n, bool)
    ref_c, ref_m = j_cost_matrix(ep, er, JCostWeights(priority=0.5))
    tp, tr = to_port(ep, er)
    got_c, got_m = cost_matrix(tp, tr, CostWeights(priority=0.5))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0, atol=COST_ATOL)


def test_cost_matrix_without_proximity_is_bit_exact():
    ep = j_synth.synth_providers(np.random.default_rng(2), 64)
    er = j_synth.synth_requirements(np.random.default_rng(3), 48)
    ref_c, _ = j_cost_matrix(ep, er, JCostWeights(proximity=0.0, priority=0.25))
    tp, tr = to_port(ep, er)
    got_c, _ = cost_matrix(tp, tr, CostWeights(proximity=0.0, priority=0.25))
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32), np.asarray(ref_c).view(np.uint32))


@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_cost_matrix_on_nan_coordinates_matches_the_reference(proximity):
    """C5: a located pair with a NaN or infinite coordinate costs NaN in
    the reference (jnp.clip keeps the NaN) and in the port's plain
    cost_matrix (torch.clamp keeps it), at every proximity (0 x NaN is
    NaN); an unlocated pair keeps its cost. The NaN cells are the same
    and every other cell is as test_cost_matrix_within_haversine_tolerance
    holds it (bit for bit at proximity 0). The card's cell_terms is held
    against the plain version on the same edit
    (tests/test_torch_kernels_cuda.py::
    test_cell_kernels_on_nan_coordinates_match_plain_bits)."""
    import dataclasses

    from tests.test_torch_kernels_cuda import nan_coord_edit

    ep = j_synth.synth_providers(np.random.default_rng(2), 64)
    er = j_synth.synth_requirements(np.random.default_rng(3), 48)
    ep, er = nan_coord_edit(ep, er)
    loc = np.array(ep.has_location, copy=True)
    loc[20] = False  # an unlocated provider: no NaN from a located task's NaN
    ep = dataclasses.replace(ep, has_location=loc)
    jw = JCostWeights(proximity=proximity, priority=0.25)
    ref_c = np.asarray(j_cost_matrix(ep, er, jw)[0])
    tp, tr = to_port(ep, er)
    got_c = cost_matrix(tp, tr, CostWeights(proximity=proximity, priority=0.25))[0].numpy()
    nan = np.isnan(ref_c)
    np.testing.assert_array_equal(np.isnan(got_c), nan)
    assert nan[3].sum() > 0 and nan[13].sum() > 0 and nan[:, 9].sum() > 0
    assert not nan[20].any()
    if proximity == 0.0:
        np.testing.assert_array_equal(got_c[~nan].view(np.uint32), ref_c[~nan].view(np.uint32))
    else:
        np.testing.assert_allclose(got_c[~nan], ref_c[~nan], rtol=0, atol=COST_ATOL)


@pytest.mark.parametrize("seed,n", [(2, 300), (7, 64)])
def test_synth_copies_match_reference(seed, n):
    jp = j_synth.synth_providers(np.random.default_rng(seed), n)
    jr = j_synth.synth_requirements(np.random.default_rng(seed + 1), n)
    tp = t_synth.synth_provider_arrays(np.random.default_rng(seed), n)
    tr = t_synth.synth_requirement_arrays(np.random.default_rng(seed + 1), n)
    for name, arr in tp.items():
        ref = np.asarray(getattr(jp, name))
        assert arr.dtype == ref.dtype, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)
    for name, arr in tr.items():
        ref = np.asarray(getattr(jr, name))
        assert arr.dtype == ref.dtype, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)
    ep = t_synth.synth_providers(np.random.default_rng(seed), n, device="cpu")
    assert ep.gpu_count.dtype == torch.int32 and ep.has_gpu.dtype == torch.uint8


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import protocol_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(protocol_tpu_torch.__path__,\n"
        "                                              'protocol_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "need = {'protocol_tpu_torch.services.scheduler_grpc', 'protocol_tpu_torch.serve',\n"
        "        'protocol_tpu_torch.proto.wire', 'protocol_tpu_torch.kernels',\n"
        "        'protocol_tpu_torch.services.session_store', 'protocol_tpu_torch.trace.format',\n"
        "        'protocol_tpu_torch.trace.replay', 'protocol_tpu_torch.trace.__main__',\n"
        "        'protocol_tpu_torch.obs.metrics', 'protocol_tpu_torch.faults.checkpoint',\n"
        "        'protocol_tpu_torch.fleet.fabric', 'protocol_tpu_torch.dfleet.topology',\n"
        "        'protocol_tpu_torch.sched.scheduler', 'protocol_tpu_torch.store.kv',\n"
        "        'protocol_tpu_torch.store.context', 'protocol_tpu_torch.store.node_store',\n"
        "        'protocol_tpu_torch.store.domains.node_store',\n"
        "        'protocol_tpu_torch.store.domains.task_store',\n"
        "        'protocol_tpu_torch.store.domains.heartbeat_store',\n"
        "        'protocol_tpu_torch.store.domains.metrics_store',\n"
        "        'protocol_tpu_torch.models.heartbeat', 'protocol_tpu_torch.models.metric',\n"
        "        'protocol_tpu_torch.security.wallet', 'protocol_tpu_torch.security.signer',\n"
        "        'protocol_tpu_torch.security.middleware', 'protocol_tpu_torch.chain.ledger',\n"
        "        'protocol_tpu_torch.chain.remote', 'protocol_tpu_torch.utils.http_client',\n"
        "        'protocol_tpu_torch.utils.storage', 'protocol_tpu_torch.utils.metrics',\n"
        "        'protocol_tpu_torch.utils.api_docs', 'protocol_tpu_torch.utils.tls',\n"
        "        'protocol_tpu_torch.sched.webhook', 'protocol_tpu_torch.services.orchestrator'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'protocol_tpu' or m.startswith('protocol_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent),
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be exercised")
    arrays = t_synth.synth_provider_arrays(np.random.default_rng(0), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        providers_from_numpy(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_synth.synth_requirements(np.random.default_rng(0), 4)
    from protocol_tpu_torch.services.scheduler_grpc import SchedulerBackendServicer, serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerBackendServicer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("127.0.0.1:0")
    from protocol_tpu_torch.trace.replay import replay

    golden = str(pathlib.Path(__file__).resolve().parent.parent / "artifacts"
                 / "golden_trace_512x512_jax.trace")
    for transport in ("inproc", "wire-v2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay(golden, transport=transport)
