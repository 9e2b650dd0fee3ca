"""Shared fixtures of the PyTorch port's parity tests (tests/test_torch_port_*.py):
network weights made with numpy from a seed, and paired JAX and port train
states, run through the JAX package and through the port."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mra_gan_tpu.models.networks import define_g
from mra_gan_tpu_torch.checkpoint.io import state_dict_from_jax
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn

# six pytest-xdist workers share the CPU
torch.set_num_threads(2)


def jax_generator(ngf: int = 4, n_blocks: int = 6, use_dropout: bool = False,
                  seed: int = 0):
    """(flax module, numpy param tree). The weights are redrawn with numpy at
    O(1) activation scale (kernel std 1/sqrt(fan_in), bias std 0.1), so that
    a wrong transpose or layer order shows in the output."""
    net = define_g(1, ngf, f"resnet_{n_blocks}blocks", use_dropout=use_dropout)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros((1, 16, 16, 16, 1)), train=False),
                            jax.random.PRNGKey(seed))
    return net, random_conv_tree(shapes, seed)


def jax_forward(net, params):
    """jitted (B, D, H, W, 1) -> (B, D, H, W, 1) float32 forward, train=False."""
    return jax.jit(lambda x: net.apply(params, x.astype(jnp.float32), train=False))


def port_generate_fn(params, n_blocks: int = 6, ngf: int = 4, use_dropout: bool = False):
    """The port's float32 GenerateFn on the CPU with the same weights."""
    cfg = CycleGANConfig(ngf=ngf, net_g=f"resnet_{n_blocks}blocks",
                         no_dropout=not use_dropout, dtype=torch.float32)
    gen = make_generate_fn(cfg, "g_a", device="cpu")
    gen.net.load_state_dict(state_dict_from_jax(params, cfg.net_g, use_dropout))
    return gen


def to_ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_conv_tree(shapes_tree, seed: int):
    """Redraw a JAX param tree (shapes from jax.eval_shape) with numpy at O(1)
    activation scale: kernel std 1/sqrt(fan_in), bias std 0.1, a norm's
    scale 1 + 0.1 N."""
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 5:
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:4]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, shapes_tree)


def jax_params(jnet, spatial, seed: int = 0):
    """A JAX net's numpy param tree for (1, *spatial, 1) inputs: the shapes
    from ``jax.eval_shape`` of its ``init``, the values ``random_conv_tree``'s."""
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, *spatial, 1)), train=False),
        jax.random.PRNGKey(seed))
    return random_conv_tree(shapes, seed)


# Every full-width instance norm of the port's paths (resnet_6blocks at ngf = 32 on
# 64^3 patches and on the 128x256x256 volume, the 3-layer PatchGAN at
# ndf = 32), written out by the route that uses_slab gives it, forward and
# backward alike: (N, C, D, H, W).
SLAB = [
    (8, 128, 16, 16, 16), (3, 128, 16, 16, 16), (16, 128, 16, 16, 16), (2, 128, 16, 16, 16),
    (1, 128, 16, 16, 16),                                          # generator trunk
    (1, 64, 16, 16, 16), (2, 64, 16, 16, 16), (8, 64, 16, 16, 16), (16, 64, 16, 16, 16),
    (1, 128, 8, 8, 8), (2, 128, 8, 8, 8), (8, 128, 8, 8, 8), (16, 128, 8, 8, 8),
    (1, 256, 7, 7, 7), (2, 256, 7, 7, 7), (8, 256, 7, 7, 7), (16, 256, 7, 7, 7),  # PatchGAN
    (2, 128, 16, 16, 28),                                          # the largest at C = 128
]
TWO_PASS = [
    (8, 32, 64, 64, 64), (3, 32, 64, 64, 64), (16, 32, 64, 64, 64), (2, 32, 64, 64, 64),
    (1, 32, 64, 64, 64), (8, 64, 32, 32, 32), (3, 64, 32, 32, 32), (16, 64, 32, 32, 32),
    (1, 64, 32, 32, 32),
    (1, 32, 128, 256, 256), (1, 64, 64, 128, 128), (1, 128, 32, 64, 64),  # the single pass
    (2, 6, 16, 16, 16),                                            # C = 6
    (2, 128, 16, 16, 29),                                          # one row past the largest
]


# The small train-step configuration of the port's step tests (as
# tests/test_torch_parity_step.py sizes its run): 16^3, ngf = ndf = 4,
# a 2-layer PatchGAN, no pool, float32.
STEP_PATCH = (16, 16, 16)
STEP_LR = 2e-4


def paired_train_states(gan_mode: str, seed: int = 0):
    """(JAX config, JAX state, port config, port state on the CPU) with the
    JAX state's initial weights loaded into the port's four networks."""
    common = dict(ngf=4, ndf=4, net_g="resnet_6blocks", net_d="n_layers", n_layers_d=2,
                  norm="instance", gan_mode=gan_mode, pool_size=0)
    return train_states(common, STEP_PATCH, seed)


def train_states(common: dict, patch, seed: int = 0):
    """``paired_train_states`` for any configuration ``common`` (the fields
    both packages' CycleGANConfig take) and patch shape."""
    from mra_gan_tpu.models.cycle_gan import CycleGANConfig as JaxConfig
    from mra_gan_tpu.models.cycle_gan import create_state as jax_create_state
    from mra_gan_tpu_torch.checkpoint.io import load_jax_nets
    from mra_gan_tpu_torch.models.cycle_gan import create_state

    jcfg = JaxConfig(**common)
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(seed), tuple(patch))
    cfg = CycleGANConfig(**common, dtype=torch.float32)
    state = create_state(cfg, seed, tuple(patch), device="cpu")
    load_jax_nets(state.nets, numpy_tree(jstate.g_params), numpy_tree(jstate.d_params),
                  cfg.net_g, not cfg.no_dropout, cfg.net_d)
    return jcfg, jstate, cfg, state


def jax_state_dicts(g_params, d_params, net_g: str = "resnet_6blocks",
                    net_d: str = "n_layers") -> dict:
    """{net name: torch-layout state dict} of JAX g_params/d_params trees (or
    of gradient trees of the same structure)."""
    out = {}
    for name, tree, arch in (("g_a", g_params, net_g), ("g_b", g_params, net_g),
                             ("d_a", d_params, net_d), ("d_b", d_params, net_d)):
        out[name] = state_dict_from_jax(numpy_tree(tree[name]), arch)
    return out


def jax_draws(rng, batch: int, size: int):
    """The (p, slot) pairs that JAX ``pool_query`` draws from ``rng``, one
    per image, for the port's ``pool_query(..., draws=...)``."""
    p, slot = [], []
    for key in jax.random.split(rng, batch):
        k1, k2 = jax.random.split(key)
        p.append(float(jax.random.uniform(k1)))
        slot.append(int(jax.random.randint(k2, (), 0, size)))
    return p, slot


def jax_step_pool_draws(rng, batch: int, size: int) -> dict:
    """The port's ``pool_draws`` for a JAX ``make_train_step`` step taken
    with ``rng``: the step splits it into (dropout, pool a, pool b) keys."""
    _, k_pool_a, k_pool_b = jax.random.split(rng, 3)
    return {"fake_a": jax_draws(k_pool_a, batch, size),
            "fake_b": jax_draws(k_pool_b, batch, size)}


def dead_bias_keys(net) -> set:
    """State-dict keys of the biases the port detaches (norm-dead)."""
    return {f"{name}.bias" for name, m in net.named_modules()
            if getattr(m, "dead_bias", False) and m.bias is not None}


def assert_tree_equal(a, b, where: str = "") -> None:
    """Plain containers of tensors (``state_to_dict``'s form), equal bit for
    bit and in type."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where
    else:
        assert a == b, where


def write_train_data(root, n: int = 2, shape=(24, 24, 24), seed: int = 0):
    """``root/images`` and ``root/labels`` with ``n`` pairs of synthetic
    volumes (labels a scaled copy of their image), as tests/test_e2e.py
    makes them."""
    from mra_gan_tpu_torch.data import nifti

    rng = np.random.RandomState(seed)
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        base = rng.rand(*shape).astype(np.float32) * 80 + 10
        nifti.save(nifti.NiftiImage(data=base, affine=np.eye(4)), root / f"images/{i}.nii")
        nifti.save(nifti.NiftiImage(data=base * 0.7 + 5, affine=np.eye(4)),
                   root / f"labels/{i}.nii")
    return root


def steps_match_jax(common: dict, patch, steps: int = 3, batch: int = 1, seed: int = 0):
    """``steps`` train steps of the JAX package's jitted ``make_train_step``
    and of the port's from the same weights (``train_states``) on the same
    numpy batches, the port's pools fed the JAX step's draws; after each
    step k: the ten losses at rtol 1e-4 * 10^k (atol 1e-6); the pools'
    counts equal and their images (the fakes of G after k updates, or the
    ones they swapped out; in [-1, 1]) at mean |diff| <= 1e-4 * 10^k and
    max <= 1e-3 * 10^k: from step 1 on the two G's parameters differ by the
    Adam walk, and a fake of step 2 differs by up to 0.022 (batch norm, the
    worst case measured); every parameter within the Adam walk bound of
    tests/test_torch_port_train_step.py after k + 1 steps (max |diff| <= 2
    (k + 1) lr, mean <= 0.15 (k + 1) lr), the norm-dead biases unmoved.
    Returns (JAX config, JAX state, port state)."""
    from mra_gan_tpu.models.cycle_gan import make_train_step as jax_make_train_step
    from mra_gan_tpu_torch.checkpoint.jax_import import pool_images_from_jax
    from mra_gan_tpu_torch.models.cycle_gan import make_train_step

    jcfg, jstate, cfg, state = train_states(common, patch, seed)
    jstep = jax.jit(jax_make_train_step(jcfg))
    step = make_train_step(cfg)
    rs = np.random.RandomState(seed + 42)
    for k in range(steps):
        a, b = (rs.uniform(-1.0, 1.0, (batch, *patch, 1)).astype(np.float32) for _ in range(2))
        rng = jax.random.PRNGKey(k)
        jstate, want = jstep(jstate, jnp.asarray(a), jnp.asarray(b), rng, STEP_LR)
        want = jax.device_get(want)
        draws = jax_step_pool_draws(rng, batch, cfg.pool_size) if cfg.pool_size else None
        _, got = step(state, to_ncdhw(a), to_ncdhw(b), STEP_LR, pool_draws=draws)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(float(got[name]), float(w), rtol=1e-4 * 10 ** k,
                                       atol=1e-6, err_msg=f"step {k}: {name}")
        for pool_name, channels in (("pool_fake_a", cfg.input_nc),
                                    ("pool_fake_b", cfg.output_nc)):
            jp, pool = getattr(jstate, pool_name), getattr(state, pool_name)
            assert pool.count == int(jp.count), f"step {k}: {pool_name} count"
            ref = pool_images_from_jax(np.asarray(jp.images), tuple(patch), channels)
            diff = (pool.images - ref).abs()
            assert float(diff.mean()) <= 1e-4 * 10 ** k, f"step {k}: {pool_name} mean"
            assert float(diff.max()) <= 1e-3 * 10 ** k, f"step {k}: {pool_name} max"
        ref = jax_state_dicts(jstate.g_params, jstate.d_params, cfg.net_g, cfg.net_d)
        for name, net in state.nets.items():
            dead = dead_bias_keys(net)
            got_sd = net.state_dict()
            assert set(got_sd) == set(ref[name]), name
            for key, w in ref[name].items():
                diff = (got_sd[key] - w).abs()
                where = f"after {k + 1} steps: {name} {key}"
                if key in dead:
                    assert float(diff.max()) == 0.0, f"{where}: a norm-dead bias moved"
                    continue
                assert float(diff.max()) <= 2 * (k + 1) * STEP_LR * 1.05, where
                assert float(diff.mean()) <= 0.15 * (k + 1) * STEP_LR, where
    return jcfg, jstate, state


def assert_jax_state_imported(state, tree) -> None:
    """``state`` after ``load_jax_state(state, tree)`` holds the JAX
    ``restore_raw`` tree exactly: parameters, Adam moments and counts (none
    for a norm-dead bias, whose JAX moments are zero), pools and step."""
    from mra_gan_tpu_torch.checkpoint.jax_import import pool_images_from_jax

    cfg = state.cfg
    assert state.step == int(tree["step"])
    want = jax_state_dicts(tree["g_params"], tree["d_params"], cfg.net_g, cfg.net_d)
    for name, net in state.nets.items():
        assert set(net.state_dict()) == set(want[name]), name
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[name][k]), f"{name} {k}"
    for opt_name, names in (("opt_g", ("g_a", "g_b")), ("opt_d", ("d_a", "d_b"))):
        opt, jt = getattr(state, opt_name), tree[opt_name]
        for name in names:
            arch = cfg.net_g if name.startswith("g") else cfg.net_d
            mu = state_dict_from_jax(numpy_tree(jt["mu"][name]), arch)
            nu = state_dict_from_jax(numpy_tree(jt["nu"][name]), arch)
            dead = dead_bias_keys(state.nets[name])
            for k, p in state.nets[name].named_parameters():
                st = opt.state.get(p, {})
                if k in dead:
                    assert not st and not mu[k].any() and not nu[k].any()
                    continue
                assert float(st["step"]) == int(jt["count"]), f"{opt_name} {name} {k}"
                assert torch.equal(st["exp_avg"], mu[k]), f"{opt_name} mu {name} {k}"
                assert torch.equal(st["exp_avg_sq"], nu[k]), f"{opt_name} nu {name} {k}"
    for pool_name, channels in (("pool_fake_a", cfg.input_nc), ("pool_fake_b", cfg.output_nc)):
        pool, jp = getattr(state, pool_name), tree[pool_name]
        assert pool.count == int(jp["count"])
        torch.testing.assert_close(
            pool.images, pool_images_from_jax(jp["images"], state.patch_shape, channels),
            rtol=0, atol=0)


# ---------------------------------------------------------------------------
# augmentation: JAX random_augment's draws in the port's form, and the policy
# check of tests/test_torch_port_augment*.py. Tolerances, on data of range r
# (2 for the [-1, 1] members): 2e-6 * r absolute for the intensity branches
# (float32 arithmetic in another order), 1e-4 * r for the resampling ones
# (grid_sample's normalisation of the grid moves a coordinate by ~1e-6 voxel).

AUG_SHAPE = (16, 16, 16)
AUG_KEYS = 64
AUG_KEY = jax.random.PRNGKey(2024)
AUG_RESAMPLING = {"rotate", "bspline", "rotate_z", "rotate_x", "rotate_y"}
AUG_INTENSITY_ATOL, AUG_RESAMPLING_ATOL = 2e-6, 1e-4


def jax_augment_draw(key, extended: bool, shape=AUG_SHAPE):
    """(choice, params) that JAX ``random_augment`` draws from ``key``, in
    the port's ``draw_params`` form (augment.py:220-300)."""
    import math

    from mra_gan_tpu_torch.data.augment import BRANCHES

    k_choice, k_a, _ = jax.random.split(key, 3)
    choice = int(jax.random.randint(k_choice, (), 0, 13 if extended else 8))
    name = BRANCHES[choice]

    def rad(d):  # deg.astype(f32) * (pi / 180) in float32
        return float(np.float32(d) * np.float32(math.pi / 180.0))

    if name == "noise":
        km, ks, kn = jax.random.split(k_a, 3)
        return choice, {"mean": float(jax.random.uniform(km, ())),
                        "std": float(jax.random.uniform(ks, (), maxval=2.0)),
                        "noise": torch.from_numpy(np.array(
                            jax.random.normal(kn, shape, jnp.float32)))}
    if name == "blur":
        return choice, {"sigma": float(jax.random.uniform(k_a, (), maxval=1.5))}
    if name == "rotate":
        kx, ky, kz = jax.random.split(k_a, 3)
        deg = [int(jax.random.randint(kx, (), -40, 40)), int(jax.random.randint(ky, (), -40, 40)),
               int(jax.random.randint(kz, (), -180, 180))]
        return choice, {"angles": [rad(d) for d in deg]}
    if name == "bspline":
        return choice, {"disp": torch.from_numpy(np.array(
            jax.random.uniform(k_a, (3, 10, 10, 10), minval=0.0, maxval=10.0)))}
    if name == "flip":
        return choice, {"axis": int(jax.random.randint(k_a, (), 0, 2))}
    if name in ("brightness", "contrast"):
        return choice, {"c": int(jax.random.randint(k_a, (), -20, 20))}
    if name == "translate":
        return choice, {"shift": np.asarray(jax.random.randint(k_a, (2,), -40, 40)).tolist()}
    if name in ("rotate_z", "rotate_x", "rotate_y"):
        axis, lo, hi = {"rotate_z": (2, -180, 180), "rotate_x": (0, -40, 40),
                        "rotate_y": (1, -40, 40)}[name]
        angles = [0.0, 0.0, 0.0]
        angles[axis] = rad(int(jax.random.randint(k_a, (), lo, hi)))
        return choice, {"angles": angles}
    if name == "imadjust":
        return choice, {"gamma": float(jax.random.uniform(k_a, (), minval=1.0, maxval=2.0))}
    return choice, {}


def augment_batch_data(seed: int, zscored: bool, n: int = AUG_KEYS):
    """(n, 16, 16, 16) image and label: [-1, 1] noise, or a z-scored image
    and a label in [0, 5] (the monai pipeline's members)."""
    rs = np.random.RandomState(seed)
    img = rs.uniform(-1, 1, (n, *AUG_SHAPE)).astype(np.float32)
    lbl = rs.uniform(-1, 1, (n, *AUG_SHAPE)).astype(np.float32)
    if zscored:
        img = (img - img.mean()) / img.std() * 1.3
        lbl = (lbl + 1.0) * 2.5
    return img, lbl


def augment_atol(name: str, arr: np.ndarray) -> float:
    r = float(arr.max() - arr.min())
    return (AUG_RESAMPLING_ATOL if name in AUG_RESAMPLING else AUG_INTENSITY_ATOL) * max(r, 1.0)


def check_augment_policy(draws, value_range, segmentation: bool, extended: bool) -> None:
    """JAX ``augment_batch`` over AUG_KEYS samples from AUG_KEY against the
    port's ``apply_choice`` of each sample's ``draws`` entry (the JAX draw of
    ``split(AUG_KEY, AUG_KEYS)[i]``); every choice of the policy occurs."""
    from mra_gan_tpu.data import augment as jaug
    from mra_gan_tpu_torch.data.augment import BRANCHES, apply_choice

    img, lbl = augment_batch_data(1, zscored=value_range is None)
    j_img, j_lbl = jaug.augment_batch(jnp.asarray(img[..., None]), jnp.asarray(lbl[..., None]),
                                      AUG_KEY, value_range=value_range,
                                      segmentation=segmentation, extended=extended)
    j_img, j_lbl = np.asarray(j_img)[..., 0], np.asarray(j_lbl)[..., 0]
    for i, (choice, params) in enumerate(draws):
        p_img, p_lbl = apply_choice(torch.from_numpy(img[i]), torch.from_numpy(lbl[i]),
                                    choice, params, value_range, segmentation)
        name = BRANCHES[choice]
        for got, want, src in ((p_img, j_img[i], img[i]), (p_lbl, j_lbl[i], lbl[i])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=augment_atol(name, src),
                                       err_msg=f"sample {i}: {name}")
    assert {c for c, _ in draws} == set(range(13 if extended else 8))


# ---------------------------------------------------------------------------
# parallel steps: the port's on gloo ranks (torch_port_parallel_ranks.py)
# against the JAX package's on the conftest's fake devices


def _grad_close(got: dict, want32: dict, want64: dict, where: str) -> None:
    """Step-0 gradients of a parallel step held at float32's reduction-order
    tolerance: per network, no farther from the float64 one-device step's
    than twice the float32 one-device step's own distance plus 2e-3 of the
    network's largest gradient (the float32 steps' error reaches 1e-2 of
    scale at the generators' stems; the sharded norms merge their
    statistics in another order), and the network's gradient norm within 1%
    of float64's: a gradient counted R times, or 1/R times, is off by 50%
    and more."""
    for name, w64 in want64.items():
        assert set(got[name]) == set(w64), f"{where}: {name}"
        scale = max(float(w.abs().max()) for w in w64.values())
        dist = lambda grads: max(float((grads[k].double() - w).abs().max())  # noqa: E731
                                 for k, w in w64.items())
        assert dist(got[name]) <= 2 * dist(want32[name]) + 2e-3 * scale, \
            f"{where}: {name} {dist(got[name])} against {dist(want32[name])} (scale {scale})"
        norm = lambda grads: float(sum(g.double().square().sum() for g in grads.values()))  # noqa: E731
        assert abs(norm(got[name]) / norm(w64) - 1.0) < 2e-2, f"{where}: {name} norm"


def one_device_steps(cfg, nets: dict, patch, batches, draws, lr: float = STEP_LR):
    """The port's one-device step from ``nets`` over the NCDHW ``batches``:
    (metrics per step, step-0 gradients, the step-0 gradients of the same
    step in float64)."""
    import dataclasses

    from mra_gan_tpu_torch.models.cycle_gan import create_state, make_train_step

    def run(c, n_steps):
        state = create_state(c, 0, tuple(patch), device="cpu")
        for name, net in state.nets.items():
            net.load_state_dict(nets[name])
            net.to(c.dtype)
        step = make_train_step(c)
        metrics, grads = [], None
        for k, (a, b) in enumerate(batches[:n_steps]):
            _, m = step(state, torch.from_numpy(a), torch.from_numpy(b), lr,
                        pool_draws=draws[k] if draws else None)
            metrics.append({n: float(v) for n, v in m.items()})
            if k == 0:
                grads = {n: {key: p.grad.clone() for key, p in net.named_parameters()
                             if p.grad is not None} for n, net in state.nets.items()}
        return metrics, grads

    metrics, grads = run(cfg, len(batches))
    _, grads64 = run(dataclasses.replace(cfg, dtype=torch.float64), 1)
    return metrics, grads, grads64


def parallel_steps_match_jax(common: dict, patch, batch: int, data: int, space: int, tmp_path,
                             bad_batches=(), steps: int = 3, seed: int = 0):
    """The port's parallel step (data-parallel for space 1, else spatial,
    2-D for data > 1) on data x space gloo ranks against the JAX package's
    ``make_sharded_train_step``/``make_spatial_train_step`` on as many fake
    devices, from the same weights, over the same batches with the pools
    fed the JAX steps' draws: the loss trajectory at JAX's own bars
    (tests/test_parallel.py:130, rtol 1e-3, 2e-3, 2e-2, atol 1e-4); the
    step-0 parameter gradients against the port's one-device step at
    float32 reduction-order tolerance; parameters bit-equal across ranks
    afterwards. Returns the ranks' results (for their ``errors`` on
    ``bad_batches``)."""
    from mra_gan_tpu.core.mesh import DATA_AXIS, SPACE_AXIS
    from mra_gan_tpu.core.mesh import make_mesh as jax_make_mesh
    from mra_gan_tpu.parallel.sharding import make_sharded_train_step, shard_state
    from mra_gan_tpu.parallel.spatial import make_spatial_train_step, shard_spatial_state
    from torch_port_parallel_ranks import rank_steps, start_ranks

    jcfg, jstate, cfg, state = train_states(common, patch, seed)
    nets = {n: net.state_dict() for n, net in state.nets.items()}
    rs = np.random.RandomState(seed + 7)
    ndhwc = [tuple(rs.uniform(-1, 1, (batch, *patch, 1)).astype(np.float32) for _ in range(2))
             for _ in range(steps)]
    batches = [tuple(np.ascontiguousarray(np.moveaxis(t, -1, 1)) for t in ab) for ab in ndhwc]
    rngs = [jax.random.PRNGKey(3 + k) for k in range(steps)]
    draws = ([jax_step_pool_draws(r, batch, cfg.pool_size) for r in rngs]
             if cfg.pool_size else None)
    bad = [np.ascontiguousarray(np.moveaxis(b, -1, 1)) for b in bad_batches]
    wait = start_ranks(rank_steps, data * space, tmp_path, common, patch, nets, batches,
                       draws, data, space, STEP_LR, bad, timeout_s=240)

    mesh = jax_make_mesh(jax.devices()[:data * space], data=data, space=space)
    if space == 1:
        jstep, sh = make_sharded_train_step(jcfg, mesh)
        jstate = shard_state(jstate, mesh)
    else:
        jstep, sh = make_spatial_train_step(jcfg, mesh, SPACE_AXIS,
                                            data_axis=DATA_AXIS if data > 1 else None)
        jstate = shard_spatial_state(jstate, mesh, SPACE_AXIS, jcfg)
    want = []
    for (a, b), rng in zip(ndhwc, rngs):
        jstate, m = jstep(jstate, jax.device_put(a, sh), jax.device_put(b, sh), rng, STEP_LR)
        want.append({n: float(v) for n, v in jax.device_get(m).items()})
    one_m, one_g, one_g64 = one_device_steps(cfg, nets, patch, batches, draws)
    results = wait()

    for k in range(steps):
        rtol = (1e-3, 2e-3, 2e-2)[min(k, 2)]
        assert set(results[0]["metrics"][k]) == set(want[k])
        for name, w in want[k].items():
            for r in results:
                np.testing.assert_allclose(r["metrics"][k][name], w, rtol=rtol, atol=1e-4,
                                           err_msg=f"step {k}: {name}")
            np.testing.assert_allclose(one_m[k][name], w, rtol=rtol, atol=1e-4,
                                       err_msg=f"one device, step {k}: {name}")
    _grad_close(results[0]["grads"], one_g, one_g64, "step-0 gradients")
    for r in results[1:]:
        assert r["counts"] == results[0]["counts"]
        for name, sd in results[0]["params"].items():
            for key, v in sd.items():
                assert torch.equal(r["params"][name][key], v), f"{name} {key} differs across ranks"
    return results
