"""The port's fused async flush against the Pallas kernel it replaces, and
the server-optimizer aggregators against the JAX package's.

On the CPU the ``fused_aggregate`` wrapper takes its plain version; it is
held against ``fused_aggregate_pallas(..., interpret=True)`` and the JAX
``ref_fused_aggregate`` on the same numpy inputs at rtol/atol 1e-6, the
gate of tests/test_aggregators.py. The aggregators' ``aggregate_stale`` is
chained over two flushes in both packages, with ``fused`` None, True and
False. The CUDA kernel runs only on a card (marker ``cuda``):

    python -m pytest -q -m cuda tests/test_torch_fused.py tests/test_torch_async.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.kernels.fedavg import fused_aggregate_pallas
from repro.kernels.ref import ref_fused_aggregate as jax_ref_fused_aggregate
from repro_torch.api.aggregator import get_aggregator
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import FUSED_MODES, LAUNCHES, fused_aggregate, reset_launches
from repro_torch.kernels.ref import ref_fused_aggregate

TOL = dict(rtol=1e-6, atol=1e-6)
SCALARS = dict(beta=0.5, lr=0.7, beta1=0.9, beta2=0.99, eps=1e-3)


def _inputs(K, N, seed):
    """Deltas, p_k-like weights, integer staleness, and moments with v > 0."""
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, K).astype(np.float32)
    s = rng.integers(0, 4, K).astype(np.float32)
    m = (0.01 * rng.standard_normal(N)).astype(np.float32)
    v = rng.uniform(1e-6, 1e-2, N).astype(np.float32)
    return x, w, s, m, v


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_aggregate_matches_pallas_and_reference(mode):
    x, w, s, m, v = _inputs(5, 1000, seed=FUSED_MODES.index(mode))
    norm = float(w.sum())
    args = [jnp.asarray(a) for a in (x, w, s, m, v)]
    want_kernel = fused_aggregate_pallas(*args, mode=mode, normalizer=norm, blk=256,
                                         interpret=True, **SCALARS)
    want_ref = jax_ref_fused_aggregate(*args, mode=mode, normalizer=norm, **SCALARS)
    got = fused_aggregate(*map(torch.from_numpy, (x, w, s, m, v)), mode=mode,
                          normalizer=norm, **SCALARS)
    for g, wk, wr in zip(got, want_kernel, want_ref):
        assert g.dtype == torch.float32 and g.shape == (1000,)
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), **TOL)


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_aggregate_cpu_is_the_plain_version(mode):
    """On the CPU: the plain version, no launch; a moment the mode leaves
    alone comes back as the input itself."""
    x, w, s, m, v = map(torch.from_numpy, _inputs(3, 77, seed=1))
    reset_launches()
    got = fused_aggregate(x, w, s, m, v, mode=mode, normalizer=w.sum(), **SCALARS)
    want = ref_fused_aggregate(x, w, s, m, v, mode=mode, normalizer=w.sum(), **SCALARS)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert LAUNCHES["fused_aggregate"] == 0
    assert (got[1] is m) == (mode == "fedavg")
    assert (got[2] is v) == (mode in ("fedavg", "fedavgm"))


@pytest.mark.parametrize("args,err", [
    (dict(mode="sgd"), ValueError),
    (dict(x=torch.zeros(8)), ValueError),
    (dict(w=torch.zeros(3)), ValueError),
    (dict(s=torch.zeros(4, 1)), ValueError),
    (dict(m=torch.zeros(7)), ValueError),
    (dict(v=torch.zeros(9)), ValueError),
    (dict(x=torch.zeros(4, 8, dtype=torch.int32)), TypeError),
    (dict(w=torch.zeros(4, dtype=torch.int64)), TypeError),
])
def test_fused_aggregate_validation(args, err):
    kw = dict(x=torch.zeros(4, 8), w=torch.ones(4), s=torch.zeros(4), m=torch.zeros(8),
              v=torch.zeros(8), mode="fedadam")
    kw.update(args)
    with pytest.raises(err):
        fused_aggregate(kw["x"], kw["w"], kw["s"], kw["m"], kw["v"], mode=kw["mode"],
                        beta=0.5, normalizer=1.0)


def _cohort(rng, K=6, shapes=((5, 4), (4,), (3, 2))):
    """A stacked-deltas numpy pytree with a leading cohort axis."""
    return [{"w": (0.1 * rng.standard_normal((K,) + shapes[0])).astype(np.float32),
             "b": (0.1 * rng.standard_normal((K,) + shapes[1])).astype(np.float32)},
            {"w": (0.1 * rng.standard_normal((K,) + shapes[2])).astype(np.float32),
             "b": (0.1 * rng.standard_normal((K, shapes[2][1]))).astype(np.float32)}]


def _assert_tree_close(got, want, **tol):
    got, want = params_to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("name", ["fedavgm", "fedadam", "fedyogi"])
def test_aggregate_stale_chained_flushes_match_jax(name, fused):
    """Two chained flushes: updates and moments match the JAX aggregator
    with the same ``fused`` option (None is the unfused per-leaf path on
    both CPUs)."""
    rng = np.random.default_rng(7)
    options = {"fused": fused}
    ja, ta = japi.get_aggregator(name, options), get_aggregator(name, options)
    template = [{k: a[0] for k, a in layer.items()} for layer in _cohort(rng)]
    js = ja.init(jax.tree.map(jnp.asarray, template))
    ts = ta.init(params_from_numpy(template, device="cpu"))
    for _ in range(2):
        cohort = _cohort(rng)
        w = rng.uniform(0.2, 1.0, 6).astype(np.float32)
        st = rng.integers(0, 3, 6).astype(np.float32)
        ju, js = ja.aggregate_stale(jax.tree.map(jnp.asarray, cohort), jnp.asarray(w), st,
                                    0.5, js, normalizer=jnp.asarray(w).sum())
        tu, ts = ta.aggregate_stale(params_from_numpy(cohort, device="cpu"),
                                    torch.from_numpy(w), st, 0.5, ts,
                                    normalizer=torch.from_numpy(w).sum())
        _assert_tree_close(tu, ju, **TOL)
        _assert_tree_close(ts, js, **TOL)


def test_fedadam_server_state_carries_across():
    """A JAX FedAdam server state, loaded into the port through interop,
    continues one flush exactly as the JAX package continues it."""
    rng = np.random.default_rng(11)
    ja, ta = japi.get_aggregator("fedadam"), get_aggregator("fedadam")
    template = [{k: a[0] for k, a in layer.items()} for layer in _cohort(rng)]
    js = ja.init(jax.tree.map(jnp.asarray, template))
    w = np.full(6, 0.5, np.float32)
    _, js = ja.aggregate_stale(jax.tree.map(jnp.asarray, _cohort(rng)), jnp.asarray(w),
                               np.zeros(6, np.float32), 0.5, js)
    ts = params_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert set(ts) == {"m", "v"}
    cohort = _cohort(rng)
    st = np.array([0, 1, 2, 0, 1, 3], np.float32)
    ju, js = ja.aggregate_stale(jax.tree.map(jnp.asarray, cohort), jnp.asarray(w), st, 0.5, js)
    tu, ts = ta.aggregate_stale(params_from_numpy(cohort, device="cpu"), torch.from_numpy(w),
                                st, 0.5, ts)
    _assert_tree_close(tu, ju, **TOL)
    _assert_tree_close(ts, js, **TOL)


@pytest.mark.parametrize("name", ["fedavg", "fedavgm", "fedadam", "fedyogi"])
def test_aggregate_without_backend_runs_on_the_inputs_device(name):
    """An aggregator built without a backend folds through ``serial`` on
    the device of its inputs (the JAX package's ``_agg_backend``)."""
    rng = np.random.default_rng(3)
    cohort = _cohort(rng)
    w = rng.uniform(0.2, 1.0, 6).astype(np.float32)
    ja, ta = japi.get_aggregator(name), get_aggregator(name)
    template = [{k: a[0] for k, a in layer.items()} for layer in cohort]
    js = ja.init(jax.tree.map(jnp.asarray, template))
    ts = ta.init(params_from_numpy(template, device="cpu"))
    ju, _ = ja.aggregate(jax.tree.map(jnp.asarray, cohort), jnp.asarray(w), js)
    tu, _ = ta.aggregate(params_from_numpy(cohort, device="cpu"), torch.from_numpy(w), ts)
    _assert_tree_close(tu, ju, **TOL)
    assert ta.backend is None
    backend = ta._agg_backend(params_from_numpy(cohort, device="cpu"))
    assert backend.name == "serial" and backend.device.type == "cpu"


@pytest.mark.parametrize("name,options", [
    ("fedavgm", {"momentum": 1.0}), ("fedavgm", {"lr": 0.0}), ("fedadam", {"beta1": 1.0}),
    ("fedyogi", {"beta2": -0.1}), ("fedadam", {"eps": 0.0}), ("fedadam", {"nesterov": True}),
])
def test_server_optimizer_options_are_checked(name, options):
    with pytest.raises(ValueError):
        japi.get_aggregator(name, options)
    with pytest.raises(ValueError):
        get_aggregator(name, options)


def test_aggregator_state_dict_records_match_jax():
    for name in ("fedavg", "fedavgm", "fedadam", "fedyogi"):
        opts = {} if name == "fedavg" else {"lr": 0.5}
        ta = get_aggregator(name, opts)
        assert ta.state_dict() == japi.get_aggregator(name, opts).state_dict()
        ta.load_state(ta.state_dict())
        with pytest.raises(ValueError):
            ta.load_state({"name": "fedmedian", "options": {}})


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1, 1), (1, 1738), (3, 3786), (4, 6922), (8, 2049),
                                 (5, 4096), (300, 1000)])
@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_aggregate_cuda_kernel_matches_plain(cuda_device, mode, K, N):
    """Scalar path (ragged N), 128-bit path (N a multiple of 4), and a K
    longer than one shared-memory chunk of discount factors."""
    x, w, s, m, v = (torch.from_numpy(a).to(cuda_device) for a in _inputs(K, N, K + N))
    reset_launches()
    got = fused_aggregate(x, w, s, m, v, mode=mode, normalizer=w.sum(), **SCALARS)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_aggregate"] == 1
    want = ref_fused_aggregate(x, w, s, m, v, mode=mode, normalizer=w.sum(), **SCALARS)
    for g, r in zip(got, want):
        assert g.device.type == "cuda" and g.shape == (N,)
        torch.testing.assert_close(g, r, **TOL)
    assert (got[1] is m) == (mode == "fedavg")
    assert (got[2] is v) == (mode in ("fedavg", "fedavgm"))


@pytest.mark.cuda
def test_fused_aggregate_cuda_misaligned_moments_take_scalar_path(cuda_device):
    K, N = 4, 4096
    x, w, s, m, v = (torch.from_numpy(a).to(cuda_device) for a in _inputs(K, N, 5))
    m_off = torch.empty(N + 1, device=cuda_device)[1:]
    m_off.copy_(m)
    got = fused_aggregate(x, w, s, m_off, v, mode="fedadam", normalizer=w.sum(), **SCALARS)
    want = ref_fused_aggregate(x, w, s, m, v, mode="fedadam", normalizer=w.sum(), **SCALARS)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fedavg", "fedavgm", "fedadam", "fedyogi"])
def test_aggregate_without_backend_follows_the_inputs_from_cpu_to_cuda(cuda_device, name):
    """One aggregator with no backend, called on CPU inputs and then on
    CUDA inputs: each call folds on its own inputs' device."""
    rng = np.random.default_rng(3)
    cohort = _cohort(rng)
    w = rng.uniform(0.2, 1.0, 6).astype(np.float32)
    template = [{k: a[0] for k, a in layer.items()} for layer in cohort]
    ta = get_aggregator(name)
    outs = []
    for dev in ("cpu", "cuda"):
        tu, _ = ta.aggregate(params_from_numpy(cohort, device=dev), torch.from_numpy(w),
                             ta.init(params_from_numpy(template, device=dev)))
        assert {leaf.device.type for leaf in jax.tree.leaves(tu)} == {dev}
        outs.append(params_to_numpy(tu))
    assert ta.backend is None
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fedavgm", "fedadam", "fedyogi"])
def test_aggregate_stale_on_cuda_launches_the_kernel_once(cuda_device, name):
    rng = np.random.default_rng(5)
    cohort = _cohort(rng)
    w = rng.uniform(0.2, 1.0, 6).astype(np.float32)
    st = rng.integers(0, 3, 6).astype(np.float32)
    template = [{k: a[0] for k, a in layer.items()} for layer in cohort]
    gpu, cpu = get_aggregator(name), get_aggregator(name, {"fused": True})
    reset_launches()
    gu, gs = gpu.aggregate_stale(params_from_numpy(cohort), torch.from_numpy(w), st, 0.5,
                                 gpu.init(params_from_numpy(template)))
    assert LAUNCHES["fused_aggregate"] == 1
    cu, cs = cpu.aggregate_stale(params_from_numpy(cohort, device="cpu"), torch.from_numpy(w),
                                 st, 0.5, cpu.init(params_from_numpy(template, device="cpu")))
    for g, c in zip(params_to_numpy([gu, gs]), params_to_numpy([cu, cs])):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(c)):
            np.testing.assert_allclose(a, b, **TOL)
