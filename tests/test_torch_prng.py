"""repro_torch.prng against jax.random (threefry2x32, partitionable):
keys, fold_in, split, random_bits, randint and normal bit for bit, on the
CPU and (the ``cuda`` case) on a card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = [0, 1, 42, 123456789, 2**31 - 1, 2**31, -1]


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches(seed):
    np.testing.assert_array_equal(_np(prng.PRNGKey(seed)), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches(seed):
    for data in [0, 1, 7, 99999, 2**31, 2**32 - 1]:
        got = _np(prng.fold_in(prng.PRNGKey(seed), data))
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(got, want)


def test_fold_in_batched_client_ids():
    """The trainer's per-client keys: fold_in(task_round_key, ids) in one call."""
    from repro.fed.trainer import task_round_key as jax_key
    from repro_torch.fed.trainer import task_round_key

    ids = np.array([0, 3, 5, 11, 39])
    got = _np(prng.fold_in(task_round_key(7, 2, 13), torch.from_numpy(ids)))
    want = np.asarray(jax.vmap(lambda c: jax.random.fold_in(jax_key(7, 2, 13), c))(
        jnp.asarray(ids)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 5, 32])
def test_split_matches(seed, num):
    got = _np(prng.split(prng.PRNGKey(seed), num))
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (32,), (2, 3, 7)])
def test_random_bits_match(seed, shape):
    got = _np(prng.random_bits(prng.PRNGKey(seed), shape))
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 2), (0, 60), (0, 150), (0, 250), (-5, 5),
                                   (3, 3), (0, 70000), (0, 2**31 - 1), (-2**31, 2**31 - 1)])
def test_randint_matches(seed, lo, hi):
    for shape in [(32,), (4, 8)]:
        got = _np(prng.randint(prng.PRNGKey(seed), shape, lo, hi))
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tau,batch,n", [(1, 32, 60), (3, 32, 150), (5, 16, 250)])
def test_local_update_index_stream_matches(tau, batch, n):
    """local_update's draws: randint(split(key, tau)[t], (batch,), 0, n),
    for a cohort of client keys at once."""
    from repro_torch.fed.client import minibatch_indices

    base = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    ids = jnp.arange(6)
    jkeys = jax.vmap(lambda c: jax.random.fold_in(base, c))(ids)
    want = jax.vmap(lambda k: jax.vmap(
        lambda kt: jax.random.randint(kt, (batch,), 0, n))(jax.random.split(k, tau)))(jkeys)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(3), 1), torch.arange(6))
    np.testing.assert_array_equal(_np(minibatch_indices(keys, tau, batch, n)), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(16, 64), (64, 10), (48, 64)])
def test_normal_close(seed, shape):
    """Bit for bit: the port evaluates erfinv as XLA:CPU does (its log1p
    and log, and FMAs in the polynomials)."""
    got = _np(prng.normal(prng.PRNGKey(seed), shape))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_on_the_card_equals_jax_bit_for_bit(seed):
    """The card takes the same evaluation as the CPU: a key draws the same
    weights on both, and those of ``jax.random.normal``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    shape = (257, 1031)
    got = prng.normal(prng.PRNGKey(seed, device=torch.device("cuda")), shape)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(_np(got), _np(prng.normal(prng.PRNGKey(seed), shape)))
    np.testing.assert_array_equal(
        _np(got), np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)))


def test_log1p_and_log_match_xla_cpu():
    """The two pieces that made the draws differ: XLA:CPU's f32 log1p (a
    rational approximation below sqrt(2) - 1, log(1 + x) above) and its
    f32 log, over the whole range erfinv gives them and beyond."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = np.concatenate([-rng.random(20000), -rng.random(2000) * 1e-4,
                        -(1 - rng.random(2000) * 1e-6), rng.random(2000) * 0.4,
                        [0.0, -0.5, -0.41421356, 0.41421356]]).astype(np.float32)
    a = a[a > -1.0]                       # the documented domain
    got = _np(prng._log1p_f32(torch.from_numpy(a)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.log1p)(a)))
    v = np.concatenate([rng.random(20000), rng.random(2000) * 1e-30,
                        1 + rng.random(2000) * 1e6, [1.0, 0.5, 2.0]]).astype(np.float32)
    np.testing.assert_array_equal(_np(prng._log_f32(torch.from_numpy(v))),
                                  np.asarray(jax.jit(jnp.log)(v)))


@pytest.mark.parametrize("draw", ["normal", "uniform"])
@pytest.mark.parametrize("lead", [(5,), (3, 4)])
def test_key_by_key_draw_equals_the_batched_draw(monkeypatch, draw, lead):
    """A batch of keys too large for one call goes key by key along the
    leading axis (``MAX_BATCHED_DRAW``); each key's draw is independent, so
    the values are the same bit for bit, and ``jax.vmap`` of the draw over
    the keys gives them too."""
    keys = prng.split(prng.PRNGKey(11), math.prod(lead)).reshape(*lead, 2)
    fn = getattr(prng, draw)
    batched = fn(keys, (6, 7))
    monkeypatch.setattr(prng, "MAX_BATCHED_DRAW", 0)
    one_by_one = fn(keys, (6, 7))
    assert one_by_one.shape == (*lead, 6, 7)
    assert torch.equal(batched.view(torch.int32), one_by_one.view(torch.int32))
    jkeys = jax.random.split(jax.random.PRNGKey(11), math.prod(lead))
    want = jax.vmap(lambda k: getattr(jax.random, draw)(k, (6, 7)))(jkeys).reshape(*lead, 6, 7)
    np.testing.assert_allclose(_np(one_by_one), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("draw", ["normal", "uniform"])
@pytest.mark.parametrize("limit", [1, 7, 40])
def test_one_key_draw_by_counter_ranges_equals_the_one_call_draw(monkeypatch, draw, limit):
    """One key's draw larger than ``MAX_BATCHED_DRAW`` goes by ranges of
    the threefry counter (a full-width expert leaf of qwen2-moe is 173 M
    values); each value depends only on the key and its position, so the
    values are the same bit for bit, and equal ``jax.random``'s."""
    key = prng.PRNGKey(13)
    fn = getattr(prng, draw)
    whole = fn(key, (6, 7))
    monkeypatch.setattr(prng, "MAX_BATCHED_DRAW", limit)
    ranged = fn(key, (6, 7))
    assert ranged.shape == (6, 7)
    assert torch.equal(whole.view(torch.int32), ranged.view(torch.int32))
    want = getattr(jax.random, draw)(jax.random.PRNGKey(13), (6, 7))
    np.testing.assert_allclose(_np(ranged), np.asarray(want), atol=1e-6, rtol=0)
