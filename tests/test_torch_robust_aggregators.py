"""The robust rules and qfedavg against the JAX package's aggregators.

``fedmedian`` and ``trimmed_mean`` are order statistics along the cohort
axis, computed in f32 in both packages: at odd and even K (where
``jnp.median`` averages the two middle values and ``torch.median`` would
not) they must agree bit for bit. ``qfedavg`` with q=0 is fedavg bit for
bit; with q=1 it is within 1e-6 of the reference with and without a
normaliser. The byzantine-delta check of tests/test_aggregators.py and
the bf16/f32 promotion are mirrored. The qfedavg fold through the CUDA
fedavg kernel is a ``cuda`` case of tests/test_torch_fedavg.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api.aggregator import get_aggregator as j_get
from repro_torch.api.aggregator import get_aggregator as t_get
from repro_torch.api.backend import get_backend

SHAPES = ((5, 4), (4,), (3, 2))


def _cohort(K, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return {f"p{i}": (scale * rng.standard_normal((K,) + s)).astype(np.float32)
            for i, s in enumerate(SHAPES)}


def _jax(cohort, dtype="float32"):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return {k: jnp.asarray(v).astype(jd) for k, v in cohort.items()}


def _torch(cohort, dtype="float32"):
    if dtype == "bfloat16":
        return {k: torch.from_numpy(v.astype(ml_dtypes.bfloat16).view(np.uint16)
                                    .astype(np.int16)).view(torch.bfloat16)
                for k, v in cohort.items()}
    return {k: torch.from_numpy(v.copy()) for k, v in cohort.items()}


def _np(tree):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32)) for k, v in tree.items()}


def _aggregate(name, options, K, seed, dtype="float32", normalizer=None, backend="vmap"):
    cohort = _cohort(K, seed)
    w = np.random.default_rng(seed + 1).uniform(0.5, 2.0, K).astype(np.float32)
    jn = None if normalizer is None else jnp.float32(normalizer)
    tn = None if normalizer is None else torch.tensor(normalizer, dtype=torch.float32)
    uj, _ = j_get(name, options).aggregate(_jax(cohort, dtype), jnp.asarray(w), None,
                                           normalizer=jn)
    agg = t_get(name, options, backend=get_backend(backend, device="cpu"))
    ut, _ = agg.aggregate(_torch(cohort, dtype), torch.from_numpy(w), None, normalizer=tn)
    return uj, ut


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("name,options", [("fedmedian", {}), ("trimmed_mean", {"trim": 0.2}),
                                          ("trimmed_mean", {"trim": 0.0}),
                                          ("trimmed_mean", {"trim": 0.49})])
def test_robust_rule_matches_reference(name, options, K):
    uj, ut = _aggregate(name, options, K, seed=K)
    for k in uj:
        assert ut[k].dtype == torch.float32 and ut[k].shape == uj[k].shape
        if name == "fedmedian":
            np.testing.assert_array_equal(ut[k].numpy(), np.asarray(uj[k]))
        else:
            np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("K", [2, 4, 6])
def test_fedmedian_even_cohort_averages_the_middle_pair(K):
    x = torch.arange(K * 3, dtype=torch.float32).reshape(K, 3)[torch.randperm(K)]
    upd, _ = t_get("fedmedian").aggregate({"p": x}, torch.ones(K), None)
    s = torch.sort(x, dim=0).values
    torch.testing.assert_close(upd["p"], (s[K // 2 - 1] + s[K // 2]) / 2, rtol=0, atol=0)
    assert not torch.equal(upd["p"], torch.median(x, dim=0).values)


def test_fedmedian_nan_column_is_nan_as_in_the_reference():
    x = _cohort(5, 3)
    x["p1"][2, 1] = np.nan
    uj, _ = j_get("fedmedian").aggregate(_jax(x), jnp.ones(5), None)
    ut, _ = t_get("fedmedian").aggregate(_torch(x), torch.ones(5), None)
    np.testing.assert_array_equal(ut["p1"].numpy(), np.asarray(uj["p1"]))
    assert np.isnan(ut["p1"][1].item())


def test_trimmed_mean_trim_zero_is_unweighted_mean():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 17)).astype(np.float32)
    upd, _ = t_get("trimmed_mean", {"trim": 0.0}).aggregate(
        {"p": torch.from_numpy(x)}, torch.from_numpy(rng.uniform(0.1, 5, 6)), None)
    np.testing.assert_allclose(upd["p"].numpy(), x.mean(axis=0), rtol=1e-6, atol=1e-6)


def test_robust_rules_shrug_off_byzantine_delta():
    """One corrupted client delta (1e3 x the honest scale): fedavg is
    dragged off, the median and the trimmed mean stay within the honest
    spread, in both packages alike."""
    rng = np.random.default_rng(4)
    K = 9
    honest = 0.01 * rng.standard_normal((K, 64)).astype(np.float32)
    poisoned = honest.copy()
    poisoned[3] = 1e3
    w = np.ones(K, np.float32)
    honest_mean = honest.mean(axis=0)
    for name, opts in (("fedavg", None), ("fedmedian", None), ("trimmed_mean", {"trim": 0.2})):
        ut, _ = t_get(name, opts).aggregate({"p": torch.from_numpy(poisoned)},
                                            torch.from_numpy(w), None)
        uj, _ = j_get(name, opts).aggregate({"p": jnp.asarray(poisoned)}, w, None)
        err = np.abs(ut["p"].numpy() - honest_mean).max()
        np.testing.assert_allclose(ut["p"].numpy(), np.asarray(uj["p"]), rtol=1e-6, atol=1e-6)
        assert err > 50.0 if name == "fedavg" else err < 0.05


@pytest.mark.parametrize("backend", ["vmap", "serial"])
def test_qfedavg_q_zero_is_bit_exact_fedavg(backend):
    cohort = _torch(_cohort(6, 7))
    w = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 2.0, 6).astype(np.float32))
    be = get_backend(backend, device="cpu")
    uq, _ = t_get("qfedavg", {"q": 0.0}, backend=be).aggregate(cohort, w, None,
                                                                normalizer=w.sum())
    uf, _ = t_get("fedavg", backend=be).aggregate(cohort, w, None, normalizer=w.sum())
    for k in uf:
        assert torch.equal(uq[k], uf[k])


@pytest.mark.parametrize("normalizer", [None, 3.5])
@pytest.mark.parametrize("q", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("K", [1, 3, 4, 8])
def test_qfedavg_matches_reference(K, q, normalizer):
    uj, ut = _aggregate("qfedavg", {"q": q}, K, seed=10 + K, normalizer=normalizer)
    for k in uj:
        np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]), atol=1e-6, rtol=0)


def test_qfedavg_upweights_high_norm_clients():
    K, N = 4, 32
    x = torch.cat([torch.full((K - 1, N), 0.1), torch.full((1, N), 1.0)])

    def pull(q):
        upd, _ = t_get("qfedavg", {"q": q}).aggregate({"p": x}, torch.ones(K), None,
                                                      normalizer=torch.tensor(float(K)))
        return float(upd["p"].mean())

    base, q1, q2 = pull(0.0), pull(1.0), pull(2.0)
    assert base == pytest.approx((0.1 * 3 + 1.0) / 4, rel=1e-5)
    assert base < q1 < q2 < 1.0


@pytest.mark.parametrize("name,options", [("fedmedian", {}), ("trimmed_mean", {"trim": 0.2}),
                                          ("qfedavg", {"q": 1.0}), ("qfedavg", {"q": 0.0})])
@pytest.mark.parametrize("K", [3, 4])
def test_bf16_cohort_promotes_and_casts_back(name, options, K):
    """A bf16 cohort with f32 weights: each rule computes in f32 and casts
    back to bf16, as the reference does."""
    uj, ut = _aggregate(name, options, K, seed=20 + K, dtype="bfloat16")
    for k in uj:
        assert ut[k].dtype == torch.bfloat16 and uj[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(ut)[k], _np(uj)[k])


@pytest.mark.parametrize("name,options,match", [
    ("trimmed_mean", {"trim": 0.5}, "trim must be in"), ("trimmed_mean", {"trim": -0.1}, "trim"),
    ("qfedavg", {"q": -1.0}, "q must be >= 0"), ("fedmedian", {"q": 1.0}, "rejected options"),
])
def test_option_errors_match_reference(name, options, match):
    with pytest.raises(ValueError) as ej:
        j_get(name, options)
    with pytest.raises(ValueError, match=match) as et:
        t_get(name, options)
    assert str(et.value) == str(ej.value)

