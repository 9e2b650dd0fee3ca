"""The port's parallel decodes on gloo ranks of the CPU
(tests/torch_port_parallel_ranks.py) against the JAX package's on the
conftest's fake CPU devices, on the same weights (drawn with numpy, carried
over by ``state_dict_from_jax``), at the generator bar (rtol 1e-3, atol
1e-4), and against the port's own one-device decodes:

- ``sharded_generator_apply`` for resnet_6blocks (2 ranks), unet_custom (2
  ranks, shard depth 32 = its granularity) and Dynet (4 ranks, the (32, 32,
  16) schedule of tests/test_parallel.py), against JAX's and against
  ``single_pass_apply``;
- ``sharded_sliding_window`` on 2 ranks against JAX's on 2 devices and
  against ``sliding_window_inference``, with a ragged last round (the
  padding entries of the round-robin); under --norm batch at batch 3
  against JAX's at its CLI's one patch per device."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mra_gan_tpu.core.mesh import make_mesh
from mra_gan_tpu.models.networks import define_g as jax_define_g
from mra_gan_tpu.parallel.spatial import sharded_generator_apply as jax_sharded_apply
from mra_gan_tpu.parallel.spatial import sharded_sliding_window as jax_sharded_window
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
from mra_gan_tpu_torch.infer.sliding_window import sliding_window_inference
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn
from mra_gan_tpu_torch.parallel.spatial import single_pass_apply
from torch_port_parallel_ranks import rank_sharded_apply, rank_sliding_window, start_ranks
from torch_port_util import jax_params

# net_g -> (config fields, volume (D, H, W), ranks)
NETS = {
    "resnet_6blocks": (dict(ngf=4, net_g="resnet_6blocks"), (32, 16, 16), 2),
    "unet_custom": (dict(ngf=2, net_g="unet_custom"), (64, 32, 32), 2),
    "Dynet": (dict(ngf=4, net_g="Dynet", dynet_sizes=(32, 32, 16)), (32, 32, 16), 4),
}


def _jax_net(fields: dict):
    kw = {"dynet_sizes": fields["dynet_sizes"]} if "dynet_sizes" in fields else {}
    return jax_define_g(1, fields["ngf"], fields["net_g"], **kw)


def _port_gen(fields: dict, sd):
    gen = make_generate_fn(CycleGANConfig(**fields, dtype=torch.float32), "g_a", device="cpu")
    gen.net.load_state_dict(sd)
    return gen


@pytest.mark.parametrize("net_g", list(NETS))
def test_sharded_generator_apply_matches_jax_and_single_pass(tmp_path, net_g):
    fields, shape, ranks = NETS[net_g]
    jnet = _jax_net(fields)
    params = jax_params(jnet, shape, seed=5)
    sd = state_dict_from_jax(params, net_g)
    vol = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
    wait = start_ranks(rank_sharded_apply, ranks, tmp_path, [(fields, sd, vol)])
    want = np.asarray(jax_sharded_apply(make_mesh(jax.devices()[:ranks]), jnet,
                                        jax.tree.map(jnp.asarray, params), vol), np.float32)
    results = [r[0] for r in wait()]
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    np.testing.assert_allclose(results[0], want, rtol=1e-3, atol=1e-4)
    one = single_pass_apply(_port_gen(fields, sd), vol)
    np.testing.assert_allclose(results[0], one, rtol=1e-3, atol=1e-4)


def test_sharded_sliding_window_matches_jax_and_the_one_device_decode(tmp_path):
    fields, _, _ = NETS["resnet_6blocks"]
    jnet = _jax_net(fields)
    params = jax_params(jnet, (8, 8, 8), seed=6)
    sd = state_dict_from_jax(params, "resnet_6blocks")
    vol = np.random.RandomState(6).uniform(-1, 1, (20, 24, 18)).astype(np.float32)
    kw = dict(patch_size=(8, 8, 8), stride_inplane=4, stride_layer=4, batch=3)
    wait = start_ranks(rank_sliding_window, 2, tmp_path, fields, sd, vol, kw)
    jparams = jax.tree.map(jnp.asarray, params)
    want = jax_sharded_window(make_mesh(jax.devices()[:2]), vol,
                              lambda x: jnet.apply(jparams, x, train=False), **kw)
    results = wait()
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_allclose(results[0], want, rtol=1e-3, atol=1e-4)
    one = sliding_window_inference(vol, _port_gen(fields, sd), **kw)
    np.testing.assert_allclose(results[0], one, rtol=1e-5, atol=1e-6)


def test_batch_norm_sharded_window_matches_jax_at_one_patch_per_device(tmp_path):
    fields = dict(ngf=4, net_g="resnet_6blocks", norm="batch")
    jnet = jax_define_g(1, 4, "resnet_6blocks", norm="batch")
    params = jax_params(jnet, (8, 8, 8), seed=9)
    sd = state_dict_from_jax(params, "resnet_6blocks")
    vol = np.random.RandomState(9).uniform(-1, 1, (20, 24, 18)).astype(np.float32)
    kw = dict(patch_size=(8, 8, 8), stride_inplane=4, stride_layer=4)
    wait = start_ranks(rank_sliding_window, 2, tmp_path, fields, sd, vol, {**kw, "batch": 3})
    jparams = jax.tree.map(jnp.asarray, params)
    want = jax_sharded_window(make_mesh(jax.devices()[:2]), vol,
                              lambda x: jnet.apply(jparams, x, train=False), **kw)
    results = wait()
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_allclose(results[0], want, rtol=1e-3, atol=1e-4)
    one = sliding_window_inference(vol, _port_gen(fields, sd), **kw, batch=8)
    np.testing.assert_allclose(results[0], one, rtol=1e-5, atol=1e-6)


def test_batch_norm_keeps_per_shard_statistics_as_jax_does(tmp_path):
    """--norm batch under either parallelism: the JAX package's batch norm
    (``Norm3D('batch')``) reads no shard context, so inside ``shard_map``
    each device normalizes with its own depth shard's (spatial) or its own
    rows' (data-parallel) statistics, and departs from the one-device
    forward. The port does the same (ROADMAP Queue C records it): a
    depth-sharded batch-norm forward on 2 ranks and a forward of each
    rank's rows match JAX's under ``shard_map``, and both differ from the
    one-device forward."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    fields = dict(ngf=4, net_g="resnet_6blocks", norm="batch")
    jnet = jax_define_g(1, 4, "resnet_6blocks", norm="batch")
    params = jax_params(jnet, (8, 8, 8), seed=8)
    sd = state_dict_from_jax(params, "resnet_6blocks")
    rs = np.random.RandomState(8)
    vol = rs.uniform(-1, 1, (32, 16, 16)).astype(np.float32)
    wait = start_ranks(rank_sharded_apply, 2, tmp_path, [(fields, sd, vol)])
    jparams = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax_sharded_apply(make_mesh(jax.devices()[:2]), jnet, jparams, vol))
    got = wait()[0][0]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    gen = _port_gen(fields, sd)
    one = single_pass_apply(gen, vol)
    assert float(np.abs(got - one).max()) > 1e-2

    # data-parallel: each device's rows normalize alone
    batch = rs.uniform(-1, 1, (4, 8, 8, 8, 1)).astype(np.float32)
    per_device = jax.jit(shard_map(lambda x: jnet.apply(jparams, x, train=True),
                                   mesh=make_mesh(jax.devices()[:2]), in_specs=P("data"),
                                   out_specs=P("data"), check_vma=False))
    want = np.asarray(per_device(jnp.asarray(batch)))
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(batch, -1, 1)))
    gen.net.train()
    with torch.no_grad():
        rows = torch.cat([gen.net(x[:2]), gen.net(x[2:])]).numpy()
        whole = gen.net(x).numpy()
    np.testing.assert_allclose(np.moveaxis(rows, 1, -1), want, rtol=1e-3, atol=1e-4)
    assert float(np.abs(rows - whole).max()) > 1e-2
