"""The hybrid (zamba2), xLSTM and encoder-decoder (whisper) families on
DTensors of a (2, 2) ('data', 'model') mesh of 4 gloo ranks, against the
port on plain tensors and the JAX package: the other half of
``tests/test_torch_dtensor_families.py``'s cases, run through its
program and held by its checks. Under ``use_pallas`` zamba2's
``ssd_scan`` and ``gated_rmsnorm`` take their local shards (B and C
shared by the heads)."""
import pytest
import test_torch_dtensor_families as fam

SECOND = ("hybrid", "xlstm", "encdec")
# kernel wrapper calls per use_pallas forward of the smoke models
CALLS = {"hybrid": {"_rms_norm": 5, "ssd_scan": 2, "gated_rmsnorm": 2, "flash_attention": 1},
         "xlstm": {"_rms_norm": 5}, "encdec": {}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return fam.run_cases(tmp_path_factory.mktemp("dtensor_families2"), SECOND)


@pytest.mark.parametrize("case", SECOND)
def test_loss_equals_plain_and_reference(results, case):
    """The DTensor loss equals the plain one within 1e-6 and the JAX
    package's within 1e-5."""
    fam.check_loss(results[case])


@pytest.mark.parametrize("case", SECOND)
def test_grads_and_adamw_step(results, case):
    """Gradients within 1e-6 x max(1, max|g|) of plain (xLSTM's mLSTM:
    within twice the plain f32 gradient's own distance from float64), one
    AdamW step by the first-step rule, placements kept."""
    fam.check_grads_and_step(results[case])


@pytest.mark.parametrize("case", SECOND)
def test_use_pallas_loss_on_local_shards(results, case):
    """The use_pallas loss equals plain; zamba2's scan and gate, every norm
    and the shared block's flash get plain local shards, as many calls as
    plain (whisper reaches no kernel)."""
    assert fam.check_pallas(results[case]) == CALLS[case]


@pytest.mark.parametrize("case", SECOND)
def test_prefill_and_decode_with_cache_spec_caches(results, case):
    """Prefill and 4 greedy tokens with ``cache_spec`` caches (Mamba2 and
    mLSTM states and convs, sLSTM states, shared-block and self/cross K/V):
    identical tokens, logits within 1e-5."""
    fam.check_decode(results[case])
