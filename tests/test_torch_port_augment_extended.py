"""The port's 13-choice augmentation policy (``--augment_extended``)
against the JAX package's, per sample, on the CPU
(torch_port_util.check_augment_policy states the tolerances)."""
import jax
import pytest

from torch_port_util import AUG_KEY, AUG_KEYS, check_augment_policy, jax_augment_draw


@pytest.fixture(scope="module")
def draws():
    return [jax_augment_draw(k, True) for k in jax.random.split(AUG_KEY, AUG_KEYS)]


@pytest.mark.parametrize("segmentation", [False, True], ids=["both", "segmentation"])
@pytest.mark.parametrize("value_range", [(-1.0, 1.0), None], ids=["range", "per_member"])
def test_extended_policy_matches_jax_per_sample(draws, value_range, segmentation):
    check_augment_policy(draws, value_range, segmentation, extended=True)
