"""The key-driven allocators of ``repro_torch.core.allocation`` and the
draws under them (``prng.gumbel``, ``categorical``, ``permutation``)
against the JAX package's, bit for bit on the CPU; the ``cuda`` cases
hold the card against the CPU."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocation as ref
from repro_torch import prng
from repro_torch.core import allocation

STRATEGIES = ("fedfair", "random", "round_robin")
N_CLIENTS = (1, 7, 40, 1000, 2000)
ALPHAS = (1.0, 3.0, 10.0)
ROUNDS = (0, 3)


def _np(t):
    return t.cpu().numpy()


def _losses(rng, S):
    return rng.uniform(0.05, 3.0, S).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 3, 5])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_allocate_matches_reference(strategy, S):
    """``allocate`` returns the reference's int32 task ids for every
    client count, alpha and round."""
    rng = np.random.default_rng([S, STRATEGIES.index(strategy)])
    for n, alpha, r in itertools.product(N_CLIENTS, ALPHAS, ROUNDS):
        losses = _losses(rng, S)
        seed = int(rng.integers(0, 2**31))
        want = np.asarray(ref.allocate(jax.random.PRNGKey(seed), strategy, jnp.asarray(losses),
                                       n, alpha, r))
        got = allocation.allocate(prng.PRNGKey(seed), strategy, losses, n, alpha, r)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(_np(got), want, err_msg=f"n={n} alpha={alpha} r={r}")


def test_round_robin_without_a_key_is_the_rotation():
    np.testing.assert_array_equal(_np(allocation.allocate_round_robin(2, 3, 7)),
                                  np.asarray(ref.allocate_round_robin(2, 3, 7)))


def test_allocate_rejects_an_unknown_strategy():
    with pytest.raises(ValueError):
        allocation.allocate(prng.PRNGKey(0), "nope", np.ones(2, np.float32), 4)


def _eligibility(rng, n_keys, S):
    elig = (rng.random((n_keys, S)) < 0.5).astype(np.float32)
    elig[::7] = 0.0                    # rows eligible for nothing
    return elig


@pytest.mark.parametrize("S", [1, 3, 5])
def test_assign_completion_matches_reference(S):
    """One completing client's next task, renormalised over its eligible
    tasks; -1 exactly where the client is eligible for nothing."""
    rng = np.random.default_rng(S)
    losses = _losses(rng, S)
    elig = _eligibility(rng, 100, S)
    for i, row in enumerate(elig):
        alpha = (1.0, 3.0, 10.0)[i % 3]
        want = int(ref.assign_completion(jax.random.PRNGKey(i), jnp.asarray(losses),
                                         jnp.asarray(row), alpha))
        got = allocation.assign_completion(prng.PRNGKey(i), losses, row, alpha)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == want, i
        assert (int(got) == -1) == (row.sum() == 0)
        assert int(got) == -1 or row[int(got)] == 1


def test_assign_completion_over_a_batch_of_keys_equals_key_by_key():
    """Keys (K, 2) and rows (K, S) in one call give each key's own draw,
    as ``jax.vmap`` of the reference does."""
    rng = np.random.default_rng(4)
    losses = _losses(rng, 3)
    elig = _eligibility(rng, 64, 3)
    keys = prng.split(prng.PRNGKey(17), 64)
    batched = allocation.assign_completion(keys, losses, elig, 3.0)
    assert batched.shape == (64,) and batched.dtype == torch.int32
    one_by_one = torch.stack([allocation.assign_completion(k, losses, row, 3.0)
                              for k, row in zip(keys, elig)])
    assert torch.equal(batched, one_by_one)
    want = jax.vmap(lambda k, e: ref.assign_completion(k, jnp.asarray(losses), e, 3.0))(
        jax.random.split(jax.random.PRNGKey(17), 64), jnp.asarray(elig))
    np.testing.assert_array_equal(_np(batched), np.asarray(want))


@pytest.mark.parametrize("S", [1, 2, 5])
def test_selection_probability_bit_for_bit(S):
    """Eq. 7's B_Sel term, p**n as the reference's integer powers
    (repeated squaring, subnormals flushed): equal bit for bit, which is
    tighter than the rtol 1e-6 gate."""
    rng = np.random.default_rng(10 + S)
    for alpha, n_sel, n_clients in itertools.product((1.0, 3.0), (0, 1, 2, 5, 10, 40),
                                                     (10, 40, 100, 1000)):
        if n_sel > n_clients:
            continue
        losses = _losses(rng, S)
        want = np.asarray(ref.selection_probability(jnp.asarray(losses), alpha, n_sel, n_clients))
        got = _np(allocation.selection_probability(losses, alpha, n_sel, n_clients))
        assert got.dtype == np.float32 and got.shape == (S, 1)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got, want)


def test_device_probabilities_match_reference_softmax():
    """The device-side Eq. 4 (XLA:CPU's f32 log and exp) is
    ``alpha_fair_probs`` bit for bit, over task counts and alphas."""
    rng = np.random.default_rng(7)
    for _ in range(100):
        S = int(rng.integers(1, 9))
        losses = rng.uniform(0.01, 5.0, S).astype(np.float32)
        alpha = float(rng.choice([0.5, 1.0, 2.0, 3.0, 10.0]))
        want = np.asarray(ref.alpha_fair_probs(jnp.asarray(losses), alpha))
        np.testing.assert_array_equal(_np(allocation._probs_on(losses, alpha, "cpu")), want)


def test_exp_matches_xla_cpu():
    """XLA:CPU's f32 exp over the range a softmax gives it and beyond,
    subnormal results flushed to zero as XLA:CPU flushes them."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-100, 0, 200_000), rng.uniform(-1, 1, 50_000),
                        rng.uniform(0, 88.7, 20_000), [0.0, -87.3, -87.4, -104.0]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(_np(prng._exp_f32(torch.from_numpy(x))),
                                  np.asarray(jax.jit(jnp.exp)(x)))


SHAPES = [(7,), (1000,), (3, 5)]


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_categorical_permutation_match_jax(seed, shape):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_np(prng.gumbel(key, shape)),
                                  np.asarray(jax.random.gumbel(jkey, shape)))
    logits = np.log(np.random.default_rng(seed).dirichlet(np.ones(shape[-1]))).astype(np.float32)
    lt = torch.from_numpy(logits)
    np.testing.assert_array_equal(_np(prng.categorical(key, lt)),
                                  np.asarray(jax.random.categorical(jkey, logits)))
    prefix = (11,) + logits.shape[:-1]
    np.testing.assert_array_equal(_np(prng.categorical(key, lt, shape=prefix)),
                                  np.asarray(jax.random.categorical(jkey, logits, shape=prefix)))
    n = int(np.prod(shape))
    x = np.arange(n, dtype=np.int32).reshape(shape)
    np.testing.assert_array_equal(_np(prng.permutation(key, torch.from_numpy(x))),
                                  np.asarray(jax.random.permutation(jkey, jnp.asarray(x))))


def test_categorical_rejects_a_shape_without_the_batch_suffix():
    with pytest.raises(ValueError):
        prng.categorical(prng.PRNGKey(0), torch.zeros(3, 4), shape=(5,))
    with pytest.raises(ValueError):
        prng.categorical(prng.split(prng.PRNGKey(0), 3), torch.zeros(4, 5))


def test_categorical_over_a_batch_of_keys_equals_key_by_key():
    """Keys (K, 2) with logits (K, *batch, S): each key's draw is the one it
    gives alone, as ``jax.vmap`` of ``jax.random.categorical`` gives."""
    keys = prng.split(prng.PRNGKey(3), 6)
    logits = torch.log_softmax(torch.from_numpy(
        np.random.default_rng(3).normal(size=(6, 2, 5)).astype(np.float32)), -1)
    batched = prng.categorical(keys, logits, shape=(4, 2))
    assert batched.shape == (6, 4, 2)
    for k, lt, got in zip(keys, logits, batched):
        assert torch.equal(got, prng.categorical(k, lt, shape=(4, 2)))
    want = jax.vmap(lambda k, lt: jax.random.categorical(k, lt, shape=(4, 2)))(
        jax.random.split(jax.random.PRNGKey(3), 6), logits.numpy())
    np.testing.assert_array_equal(_np(batched), np.asarray(want))


def test_permutation_at_100k_differs_only_at_tied_final_keys():
    """n = 100,000: two rounds, about one tied pair of 32-bit keys a round.
    The result is held equal everywhere but the positions whose final-round
    keys tie; and, since the port sorts stably as XLA does here
    (``sort_key_val`` is stable by default), at those positions too."""
    n, seed = 100_000, 5
    key = prng.PRNGKey(seed)
    got = _np(prng.permutation(key, torch.arange(n, dtype=torch.int32)))
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), jnp.arange(n)))
    rounds = int(np.ceil(3 * np.log(n) / np.log(2**32 - 1)))
    assert rounds == 2
    for _ in range(rounds):
        key, sub = prng.split(key)
    final = np.sort(_np(prng.random_bits(sub, (n,))))
    tied_vals = final[1:][final[1:] == final[:-1]]
    tied = np.isin(final, tied_vals)          # output positions holding tied keys
    np.testing.assert_array_equal(got[~tied], want[~tied])
    np.testing.assert_array_equal(got[tied], want[tied])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")




@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 100_000])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_allocate_on_the_card_equals_the_cpu(strategy, n):
    """Bit-equal with the CPU, with no host sync (inputs on the card)."""
    dev = _card()
    losses = np.array([0.9, 0.4, 1.7, 0.2, 0.6], np.float32)
    keys = prng.split(prng.PRNGKey(0), 4).to(dev)
    card_losses = torch.from_numpy(losses).to(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [allocation.allocate(k, strategy, card_losses, n, 3.0, 2) for k in keys]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for k, g in zip(keys.cpu(), got):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g.cpu(), allocation.allocate(k, strategy, losses, n, 3.0, 2))


@pytest.mark.cuda
def test_assign_completion_and_selection_probability_on_the_card_equal_the_cpu():
    dev = _card()
    rng = np.random.default_rng(3)
    losses = _losses(rng, 5)
    elig = _eligibility(rng, 200, 5)
    for i, row in enumerate(elig):
        got = allocation.assign_completion(prng.PRNGKey(i, device=dev), losses, row, 3.0)
        assert got.device.type == "cuda"
        assert int(got) == int(allocation.assign_completion(prng.PRNGKey(i), losses, row, 3.0))
    keys = prng.split(prng.PRNGKey(5), 200)
    assert torch.equal(allocation.assign_completion(keys.to(dev), losses, elig, 3.0).cpu(),
                       allocation.assign_completion(keys, losses, elig, 3.0))
    on_card = allocation.selection_probability(torch.from_numpy(losses).to(dev), 3.0, 5, 100)
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), allocation.selection_probability(losses, 3.0, 5, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_draws_on_the_card_equal_the_cpu(shape):
    dev = _card()
    key, ckey = prng.PRNGKey(9, device=dev), prng.PRNGKey(9)
    g = prng.gumbel(key, shape)
    assert torch.equal(g.cpu().view(torch.int32), prng.gumbel(ckey, shape).view(torch.int32))
    logits = torch.log_softmax(torch.arange(shape[-1], dtype=torch.float32), 0)
    assert torch.equal(prng.categorical(key, logits.to(dev), shape=(64,) + shape[:-1]).cpu(),
                       prng.categorical(ckey, logits, shape=(64,) + shape[:-1]))
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    assert torch.equal(prng.permutation(key, x.to(dev)).cpu(), prng.permutation(ckey, x))
