"""The port's decoders (mra_gan_tpu_torch/infer/sliding_window.py and
parallel/spatial.py) against the JAX package's, with the same generator
weights, in float32 on the CPU at rtol 1e-3 / atol 1e-4. Under --norm batch
the port's window normalizes each patch alone (the reference's batch of 1):
held against JAX's window at batch 1, and independent of the batch."""
import numpy as np
import pytest
import torch

from mra_gan_tpu.infer import sliding_window as jax_sw
from mra_gan_tpu.models.networks import define_g as jax_define_g
from mra_gan_tpu.parallel.spatial import single_pass_apply as jax_single_pass
from mra_gan_tpu_torch import test as port_cli
from mra_gan_tpu_torch.checkpoint.io import save_reference_pth, state_dict_from_jax
from mra_gan_tpu_torch.data import nifti
from mra_gan_tpu_torch.infer import sliding_window as port_sw
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn
from mra_gan_tpu_torch.parallel.spatial import single_pass_apply

from torch_port_util import jax_forward, jax_generator, jax_params, port_generate_fn


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


# --norm batch: the ROADMAP's measurement of the fault (a 20 x 24 x 18 volume,
# 8^3 patches at stride 4: 80 patches)
BN_VOLUME, BN_KW = (20, 24, 18), dict(patch_size=(8, 8, 8), stride_inplane=4, stride_layer=4)


@pytest.fixture(scope="module")
def batch_norm_nets():
    jnet = jax_define_g(1, 4, "resnet_6blocks", norm="batch")
    params = jax_params(jnet, (8, 8, 8), seed=13)
    gen = make_generate_fn(CycleGANConfig(ngf=4, norm="batch", dtype=torch.float32), "g_a",
                           device="cpu")
    gen.net.load_state_dict(state_dict_from_jax(params, "resnet_6blocks"))
    vol = np.random.RandomState(13).uniform(-1, 1, BN_VOLUME).astype(np.float32)
    return jax_forward(jnet, params), gen, vol


def test_batch_norm_window_is_independent_of_decode_batch(batch_norm_nets):
    _, gen, vol = batch_norm_nets
    one = port_sw.sliding_window_inference(vol, gen, **BN_KW, batch=1)
    eight = port_sw.sliding_window_inference(vol, gen, **BN_KW, batch=8)
    np.testing.assert_allclose(eight, one, rtol=0, atol=1e-5)
    # the generator alone, at batch 8, still takes the batch's statistics
    x = torch.from_numpy(vol[:16, :16, :16].copy()).reshape(8, 1, 8, 8, 8)
    apart = torch.cat([gen(x[i:i + 1]) for i in range(8)])
    assert float((gen(x) - apart).abs().max()) > 1e-2


def test_batch_norm_window_matches_jax_at_decode_batch_1(batch_norm_nets):
    jax_fn, gen, vol = batch_norm_nets
    ref = jax_sw.sliding_window_inference(vol, jax_fn, **BN_KW, batch=1)
    got = port_sw.sliding_window_inference(vol, gen, **BN_KW, batch=8)
    assert got.shape == ref.shape == BN_VOLUME
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_batch_norm_cli_decode_is_independent_of_decode_batch(batch_norm_nets, tmp_path):
    _, gen, _ = batch_norm_nets
    (tmp_path / "ck" / "run").mkdir(parents=True)
    save_reference_pth(gen.net, tmp_path / "ck" / "run" / "latest_net_G_A.pth")
    rs = np.random.RandomState(14)
    (tmp_path / "in").mkdir()
    for i, shape in enumerate([(21, 18, 13), (16, 20, 10)]):
        nifti.save(nifti.NiftiImage(data=(rs.rand(*shape) * 80 + 10).astype(np.float32),
                                    affine=np.diag([1.0, 1.0, 1.5, 1.0])),
                   tmp_path / "in" / f"{i}.nii.gz")
    outs = {}
    for batch in (1, 8):
        outs[batch] = tmp_path / f"out{batch}"
        assert port_cli.main([
            "--image", str(tmp_path / "in"), "--result", str(outs[batch]),
            "--checkpoints_dir", str(tmp_path / "ck"), "--name", "run", "--device", "cpu",
            "--ngf", "4", "--norm", "batch", "--patch_size", "8", "8", "8",
            "--stride_inplane", "4", "--stride_layer", "4", "--precision", "float32",
            "--decode_batch", str(batch)]) == []
    for name in ("0.nii.gz", "1.nii.gz"):
        one, eight = nifti.load(outs[1] / name).data, nifti.load(outs[8] / name).data
        assert one.shape == eight.shape and np.all(np.isfinite(one))
        # atol 1e-5 on the generator's [-1, 1], in the CLI's 0-255 output
        np.testing.assert_allclose(eight, one, rtol=0, atol=1e-5 * 127.5)


def _decode_per_patch(volume, generate_fn, patch, stride, blend, batch):
    """The decode with the window sum made per patch beside the output sum
    and each weight cast at each call: what sliding_window_inference computes
    with its kept window sums and casts."""
    strides = (stride,) * 3
    padded = [max(v, p) for v, p in zip(volume.shape, patch)]
    vol = torch.nn.functional.pad(
        torch.from_numpy(volume).to(generate_fn.dtype),
        [x for v, p in reversed(list(zip(volume.shape, padded))) for x in (0, p - v)])
    win_np = port_sw.gaussian_window(patch) if blend == "gaussian" else np.ones(patch, np.float32)
    win = torch.from_numpy(win_np)
    acc = torch.zeros(padded)
    wsum = torch.zeros(padded)
    starts = port_sw.patch_grid(volume.shape, patch, strides)
    for i in range(0, len(starts), batch):
        chunk = starts[i:i + batch]
        x = torch.stack([vol[a:a + patch[0], b:b + patch[1], c:c + patch[2]]
                         for a, b, c in chunk])[:, None]
        with torch.no_grad():
            out = generate_fn.net(x.to(generate_fn.dtype))[:, 0].float() * win
        for (a, b, c), o in zip(chunk, out):
            acc[a:a + patch[0], b:b + patch[1], c:c + patch[2]] += o
            wsum[a:a + patch[0], b:b + patch[1], c:c + patch[2]] += win
    out = acc / wsum.clamp_min(1e-8)
    return out[:volume.shape[0], :volume.shape[1], :volume.shape[2]].numpy()


@pytest.mark.parametrize("blend", ["gaussian", "uniform"])
def test_kept_window_sums_give_the_per_patch_bits(nets, blend):
    port_fn = nets[3]
    shape, patch = (36, 20, 18), (16, 16, 16)
    vol = np.random.RandomState(5).uniform(-1, 1, shape).astype(np.float32)
    want = _decode_per_patch(vol, port_fn, patch, 8, blend, 4)
    for _ in range(2):  # the second call reads the kept sums
        got = port_sw.sliding_window_inference(vol, port_fn, patch, 8, 8, blend, 4)
        np.testing.assert_array_equal(got, want)


def test_window_sums_are_made_once_a_geometry():
    key = ((40, 24, 16), (16, 16, 16), (8, 8, 8), "gaussian", torch.device("cpu"))
    win, wsum = port_sw._blend_weights(*key)
    assert port_sw._blend_weights(*key)[1] is wsum
    want = torch.zeros(key[0])
    for a, b, c in port_sw.patch_grid(key[0], key[1], key[2]):
        want[a:a + 16, b:b + 16, c:c + 16] += win
    torch.testing.assert_close(wsum, want.clamp_min(1e-8), rtol=0, atol=0)
    assert port_sw._blend_weights(key[0], key[1], key[2], "uniform", key[4])[1] is not wsum


def test_inference_keeps_a_weight_cast_until_the_weight_changes():
    from mra_gan_tpu_torch.ops.conv import _cast

    w = torch.nn.Parameter(torch.randn(4, 3, 3, 3, 3))
    with torch.inference_mode():
        first = _cast(w, torch.bfloat16)
        assert _cast(w, torch.bfloat16) is first
        assert _cast(w, torch.float32) is w and _cast(None, torch.bfloat16) is None
    with torch.no_grad():
        w.mul_(2)  # an optimizer's or a loader's in-place update
    with torch.inference_mode():
        again = _cast(w, torch.bfloat16)
    assert again is not first
    torch.testing.assert_close(again, (w.detach() * 1).bfloat16(), rtol=0, atol=0)
    # with gradients recorded every call casts afresh, so autograd sees the cast
    y = _cast(w, torch.bfloat16)
    assert y.requires_grad and y is not _cast(w, torch.bfloat16)
    plain = torch.randn(3, 3)
    with torch.inference_mode():
        assert _cast(plain, torch.bfloat16) is not _cast(plain, torch.bfloat16)


@pytest.mark.parametrize("shape,patch,strides,batch", [
    ((128, 256, 256), (64, 64, 64), (32, 32, 32), 8),
    ((36, 20, 18), (16, 16, 16), (8, 8, 8), 4),
    ((24, 20, 18), (16, 16, 16), (6, 6, 5), 3),
    ((10, 20, 18), (16, 16, 16), (8, 8, 8), 4),
    ((40, 24, 16), (16, 16, 16), (8, 8, 8), 1),
])
def test_transfer_marks_cover_what_each_batch_reads_and_writes(shape, patch, strides, batch):
    starts = port_sw.patch_grid(shape, patch, strides)
    batches = [starts[i:i + batch] for i in range(0, len(starts), batch)]
    marks = port_sw.transfer_marks(batches, patch[0], shape[0])
    assert len(marks) == len(batches) and marks[-1][1] == shape[0]
    needs, finals = zip(*marks)
    assert list(needs) == sorted(needs) and list(finals) == sorted(finals)
    for k, (chunk, (need, final)) in enumerate(zip(batches, marks)):
        # every plane a batch reads is up; no later patch adds to a final plane
        assert all(min(a + patch[0], shape[0]) <= need for a, _, _ in chunk)
        assert all(final <= a for later in batches[k + 1:] for a, _, _ in later)
        # and no plane waits longer than it must
        assert need == max(min(a + patch[0], shape[0]) for c in batches[:k + 1] for a, _, _ in c)
        assert k + 1 == len(batches) or final == min(a for c in batches[k + 1:] for a, _, _ in c)


def test_slab_transfers_give_the_whole_volume_bits(nets):
    # three upload and three download slabs along X, a short last batch,
    # and both wire dtypes, against the per-patch decode
    port_fn = nets[3]
    shape, patch = (40, 20, 18), (16, 16, 16)
    vol = np.random.RandomState(9).uniform(-1, 1, shape).astype(np.float32)
    starts = port_sw.patch_grid(shape, patch, (8, 8, 8))
    batches = [starts[i:i + 5] for i in range(0, len(starts), 5)]
    assert len({m[0] for m in port_sw.transfer_marks(batches, 16, 40)}) >= 3
    want = _decode_per_patch(vol, port_fn, patch, 8, "gaussian", 5)
    got = port_sw.sliding_window_inference(vol, port_fn, patch, 8, 8, "gaussian", 5)
    np.testing.assert_array_equal(got, want)
    half = port_sw.sliding_window_inference(vol, port_fn, patch, 8, 8, "gaussian", 5,
                                            transfer_dtype=torch.float16)
    np.testing.assert_array_equal(half, torch.from_numpy(want).half().float().numpy())


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_inference_norm_and_bias_skip_autograd_with_the_same_bits(act):
    from mra_gan_tpu_torch.models.networks import Conv3d
    from mra_gan_tpu_torch.ops.norm import InstanceNormAct, instance_norm_act

    x = torch.randn(2, 8, 6, 5, 4, generator=torch.Generator().manual_seed(3))
    recorded = InstanceNormAct.apply(x.clone().requires_grad_(True), 1e-5, act, 0.2, None)
    assert recorded.grad_fn is not None
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            y = instance_norm_act(x, act=act)
        assert y.grad_fn is None
        torch.testing.assert_close(y, recorded.detach(), rtol=0, atol=0)
    y = instance_norm_act(x, act=act)  # grad on, but nothing needs one
    assert y.grad_fn is None
    torch.testing.assert_close(y, recorded.detach(), rtol=0, atol=0)
    conv = Conv3d(8, 8, 3, dead_bias=True)
    with torch.inference_mode():
        assert conv.live_bias() is conv.bias  # so ops.conv keeps its cast
    assert conv.live_bias() is not conv.bias and not conv.live_bias().requires_grad


def test_decode_load_times_each_load_and_stops_its_spinners(monkeypatch):
    from mra_gan_tpu_torch import decode_load

    started, spin = [], decode_load.spinners

    def spinners(n):
        started.append(spin(n))
        return started[-1]

    monkeypatch.setattr(decode_load, "spinners", spinners)
    calls = []
    lines = list(decode_load.under_load(lambda: calls.append(1), [0, 2], 3))
    assert [line["load"] for line in lines] == [0, 2] and len(calls) == 12
    for line in lines:
        for run in ("dropped", "kept"):
            t = line[run]
            assert 0 <= t["min"] <= t["median"] <= t["p75"] <= t["max"]
    assert [len(procs) for procs in started] == [0, 2]
    assert all(p.poll() is not None for procs in started for p in procs)

    def fails():
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(decode_load.under_load(fails, [1], 2))
    assert all(p.poll() is not None for p in started[-1])
