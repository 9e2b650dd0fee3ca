"""The port's decoders (mra_gan_tpu_torch/infer/sliding_window.py and
parallel/spatial.py) against the JAX package's, with the same generator
weights, in float32 on the CPU at rtol 1e-3 / atol 1e-4."""
import numpy as np
import pytest

from mra_gan_tpu.infer import sliding_window as jax_sw
from mra_gan_tpu.parallel.spatial import single_pass_apply as jax_single_pass
from mra_gan_tpu_torch.infer import sliding_window as port_sw
from mra_gan_tpu_torch.parallel.spatial import single_pass_apply

from torch_port_util import jax_forward, jax_generator, port_generate_fn


@pytest.fixture(scope="module")
def nets():
    jnet, params = jax_generator(seed=7)
    return jnet, params, jax_forward(jnet, params), port_generate_fn(params)


def test_grid_and_window_are_jax_copies():
    for size, patch, stride in [(16, 16, 8), (40, 16, 8), (36, 16, 8), (24, 16, 6),
                                (10, 16, 8), (128, 64, 32), (256, 64, 32), (70, 64, 7)]:
        assert port_sw.compute_grid_starts(size, patch, stride) == \
            jax_sw.compute_grid_starts(size, patch, stride)
    for patch in [(16, 16, 16), (64, 64, 64), (8, 12, 5)]:
        np.testing.assert_array_equal(port_sw.gaussian_window(patch),
                                      jax_sw.gaussian_window(patch))


# (volume shape, stride_inplane, stride_layer), each through a different JAX path
VOLUMES = [
    ((32, 24, 16), 8, 8),   # strides divide the patch, X > patch: streamed overlap-add
    ((36, 20, 18), 8, 8),   # stride does not divide size - patch: flush rows
    ((24, 20, 18), 6, 5),   # stride does not divide the patch: scan
]


@pytest.mark.parametrize("blend", ["gaussian", "uniform"])
@pytest.mark.parametrize("shape,s_in,s_layer", VOLUMES)
def test_sliding_window_matches_jax(nets, shape, s_in, s_layer, blend):
    _, _, jax_fn, port_fn = nets
    vol = np.random.RandomState(sum(shape)).uniform(-1, 1, shape).astype(np.float32)
    kw = dict(patch_size=(16, 16, 16), stride_inplane=s_in, stride_layer=s_layer,
              blend=blend, batch=4)
    ref = jax_sw.sliding_window_inference(vol, jax_fn, **kw)
    got = port_sw.sliding_window_inference(vol, port_fn, **kw)
    assert got.shape == ref.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_patch_count_and_short_last_batch(nets):
    """The bench volume's grid: 3 x 7 x 7 = 147 patches, 19 batches of 8 with
    a short last one of 3."""
    starts = port_sw.patch_grid((128, 256, 256), (64, 64, 64), (32, 32, 32))
    assert len(starts) == 147 and len(starts) % 8 == 3
    calls = []
    port_fn = nets[3]

    def counting(x):
        calls.append(x.shape[0])
        return port_fn(x)

    counting.device, counting.dtype = port_fn.device, port_fn.dtype
    vol = np.zeros((20, 16, 16), np.float32)
    port_sw.sliding_window_inference(vol, counting, (16, 16, 16), 2, 8, batch=2)
    assert calls == [2, 1]


def test_single_pass_matches_jax(nets):
    jnet, params, _, port_fn = nets
    vol = np.random.RandomState(9).uniform(-1, 1, (18, 13, 10)).astype(np.float32)
    ref = jax_single_pass(jnet, params, vol)
    got = single_pass_apply(port_fn, vol)
    assert got.shape == ref.shape == vol.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
