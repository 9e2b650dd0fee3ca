"""CycleGAN: configuration, state, the train step and the inference forward
(counterpart of mra_gan_tpu/models/cycle_gan.py:39,171,201,231,476).

The train step is the reference's optimize_parameters as the JAX package
runs it, one call per iteration:

- the G loss from four batched generator applies (the two "leaf" applies
  on [real_a, real_b] and [real_b, real_a] give the fakes and the identity
  outputs, the two "chain" applies the reconstructions) and the two
  discriminators on the fakes; the gradient is taken over G's parameters
  only, so D is frozen for it;
- the G Adam step;
- both image pools queried with the pre-update fakes, detached;
- the D loss on real and pooled fake stacked into one apply per
  discriminator, then the D Adam step.

Under batch norm the statistics couple the samples of one apply, so
stacking changes the result: there, as in JAX (cycle_gan.py:244, 316-324,
369-373), the G loss runs six separate generator applies (fake_b, rec_a,
fake_a, rec_b, idt_a, idt_b) and the D loss four (real and fake apart).

The correlation-coefficient losses are computed on the detached fakes and
logged, not optimized (JAX :338-341). Everything runs on the device the state
was created on, in channels_last_3d on CUDA, with the configured compute
dtype over float32 parameters.

The same step runs one rank's part of a parallel step (JAX :274-287,
:410-460) when called inside a shard context (core.spatial_ctx), as
parallel/sharding.py and parallel/spatial.py do:

- under ``spatial_sharding`` the volumes are depth shards: the generators
  run shard-aware (halo convs, norms over the whole volume), and the
  discriminators run on volumes all-gathered along depth under
  ``spatial_unsharded``, the gather's backward returning each shard's
  gradient to the rank that made it;
- under a data axis (``data_sharding``, or the 2-D grid) the batch is split:
  the pools see the fakes all-gathered over it, every rank runs the same
  ``pool_query`` with the same draws and keeps its rows;
- losses, and so the metrics, are the global ones on every rank
  (ops/losses.py), while each rank differentiates its own shard's terms;
  the gradients are then summed over every shard axis in one flat bucket
  per optimizer and divided by the number of ranks. That counts each
  gradient once: a term computed on gathered volumes comes back R times
  through the gather's reduce-scatter, and the average divides it out.
  Parameters stay bit-equal across ranks (each all-reduce leaves the same
  bits on every rank, and Adam is elementwise)."""
from __future__ import annotations

import contextvars
import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint as torch_checkpoint
from torch import nn

from ..core.device import resolve_device
from ..core.dtypes import set_conv_precision
from ..core.spatial_ctx import (data_shard_info, shard_axes, spatial_shard_info,
                                spatial_unsharded)
from ..ops.conv import param_casts
from ..ops.losses import cor_coe_loss, gan_loss, l1_loss
from ..parallel.collectives import all_gather, all_gather_stacked, all_reduce_
from .networks import Dropout, check_patch, define_d, define_g, remat_segments

_CL = torch.channels_last_3d


@dataclasses.dataclass(frozen=True)
class CycleGANConfig:
    input_nc: int = 1
    output_nc: int = 1
    ngf: int = 32
    ndf: int = 32
    net_g: str = "resnet_6blocks"
    net_d: str = "n_layers"
    n_layers_d: int = 3
    norm: str = "instance"
    no_dropout: bool = True
    init_type: str = "normal"
    init_gain: float = 0.02
    # the reference's effective default (its --no_lsgan is store_false); pass
    # gan_mode="lsgan" for least-squares GAN
    gan_mode: str = "vanilla"
    lambda_a: float = 10.0
    lambda_b: float = 10.0
    lambda_identity: float = 0.5
    lambda_co_a: float = 2.0
    lambda_co_b: float = 2.0
    pool_size: int = 50
    beta1: float = 0.5
    dtype: torch.dtype = torch.float32
    # the Dynet's auto-schedule inputs (JAX cycle_gan.py:76-77); the
    # reference hard-codes the first, the driver takes them from the flags
    dynet_sizes: Tuple[int, int, int] = (128, 128, 64)
    dynet_spacings: Tuple[float, float, float] = (1.5, 1.5, 1.5)
    # recompute the generators' activations in the backward (--remat)
    remat: bool = False

    @staticmethod
    def modify_commandline_options(parser, is_train: bool):
        """The CycleGAN's own flags and default overrides, injected by the
        options layer's two-phase parse (JAX cycle_gan.py:80)."""
        parser.set_defaults(no_dropout=True)
        if is_train:
            parser.add_argument("--lambda_A", type=float, default=10.0,
                                help="weight for cycle loss (A -> B -> A)")
            parser.add_argument("--lambda_B", type=float, default=10.0,
                                help="weight for cycle loss (B -> A -> B)")
            parser.add_argument("--lambda_identity", type=float, default=0.5,
                                help="identity mapping loss weight factor")
            parser.add_argument("--lambda_co_A", type=float, default=2.0,
                                help="weight for correlation coefficient loss (A -> B)")
            parser.add_argument("--lambda_co_B", type=float, default=2.0,
                                help="weight for correlation coefficient loss (B -> A)")
        return parser

    def build_generator(self, which: str = "g_a",
                        generator: Optional[torch.Generator] = None) -> nn.Module:
        """g_a maps domain A (input_nc channels) to B (output_nc), g_b back.
        float32 parameters on the CPU, drawn from ``generator``."""
        if which not in ("g_a", "g_b"):
            raise ValueError(f"which must be 'g_a' or 'g_b', got {which!r}")
        cin, cout = ((self.input_nc, self.output_nc) if which == "g_a"
                     else (self.output_nc, self.input_nc))
        return define_g(cin, cout, self.ngf, self.net_g, self.norm, not self.no_dropout,
                        self.init_type, self.init_gain, generator, self.dynet_sizes,
                        self.dynet_spacings)

    def build_discriminator(self, which: str = "d_a",
                            generator: Optional[torch.Generator] = None) -> nn.Module:
        """d_a judges domain B (output_nc channels), d_b domain A; a sigmoid
        head under vanilla GAN. float32 parameters on the CPU."""
        if which not in ("d_a", "d_b"):
            raise ValueError(f"which must be 'd_a' or 'd_b', got {which!r}")
        cin = self.output_nc if which == "d_a" else self.input_nc
        return define_d(cin, self.ndf, self.net_d, self.n_layers_d, self.norm,
                        self.gan_mode == "vanilla", self.init_type, self.init_gain, generator)


class ImagePool:
    """The reference's ImagePool as a buffer of ``size`` images on the
    device, (max(size, 1), C, D, H, W), and the count filled so far."""

    def __init__(self, size: int, image_shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device):
        self.size = size
        self.images = torch.zeros((max(size, 1), *image_shape), dtype=dtype, device=device)
        self.count = 0


def pool_query(pool: ImagePool, images: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Tuple[Sequence[float], Sequence[int]]] = None) -> torch.Tensor:
    """JAX ``pool_query`` (cycle_gan.py:201), image by image in batch order:
    while the pool fills, store the image and return it; once full, with
    p > 0.5 swap it with slot ``slot`` and return the evicted image, else
    return it. ``pool`` is updated in place. The draws (p uniform in [0, 1),
    slot in [0, size)) come from the CPU ``generator``, or are given as
    ``draws = (p, slot)``, one of each per image, so that a test can feed
    the JAX package's own. No draw touches the device."""
    if pool.size == 0:
        return images
    b = images.shape[0]
    if draws is None:
        draws = (torch.rand(b, generator=generator).tolist(),
                 torch.randint(0, pool.size, (b,), generator=generator).tolist())
    p, slot = draws
    out = images
    for i in range(b):
        if pool.count < pool.size:
            pool.images[pool.count].copy_(images[i])
            pool.count += 1
        elif p[i] > 0.5:
            if out is images:
                out = images.clone()
            out[i].copy_(pool.images[slot[i]])
            pool.images[slot[i]].copy_(images[i])
    return out


@dataclasses.dataclass(eq=False)
class CycleGANState:
    """The four networks, both Adam chains, both pools, the pools' random
    generator (CPU), the dropout modules' generator (on ``device``), the step
    count, and the configuration and patch shape the state was made for.
    Unlike the JAX package's state it is mutable: ``make_train_step``'s step
    updates it in place."""

    cfg: CycleGANConfig
    patch_shape: Tuple[int, int, int]
    g_a: nn.Module
    g_b: nn.Module
    d_a: nn.Module
    d_b: nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    pool_fake_a: ImagePool
    pool_fake_b: ImagePool
    generator: torch.Generator
    dropout_generator: torch.Generator
    device: torch.device
    step: int = 0
    # the depth-shard axis whose shards the pools hold (the spatial step,
    # parallel/spatial.py shard_spatial_state); None: whole patches
    pool_shard: Optional[object] = None

    @property
    def nets(self) -> Dict[str, nn.Module]:
        return {"g_a": self.g_a, "g_b": self.g_b, "d_a": self.d_a, "d_b": self.d_b}


def _adam(params, beta1: float) -> torch.optim.Adam:
    # optax.scale_by_adam(b1=beta1, b2=0.999, eps=1e-8); lr is set per step
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, 0.999), eps=1e-8)


def create_state(cfg: CycleGANConfig, seed: int = 0,
                 patch_shape: Tuple[int, int, int] = (64, 64, 64),
                 device: Optional[Union[str, torch.device]] = None) -> CycleGANState:
    """All four networks (weights drawn from ``seed`` on the CPU, in the
    order g_a, g_b, d_a, d_b), both optimizers and empty pools for
    ``patch_shape`` patches, on ``device`` (CUDA by default; channels_last_3d
    there). The pools draw from the CPU generator that drew the weights, the
    dropout modules (``no_dropout=False``) from a generator on ``device``
    seeded with ``seed``. Load trained or JAX weights into ``state.nets``
    afterwards (checkpoint.io.load_jax_nets), or a whole saved state with
    ``checkpoint.CheckpointManager.restore``."""
    dev = resolve_device(device)
    check_patch(cfg.net_g, patch_shape)
    set_conv_precision(cfg.dtype)
    gen = torch.Generator().manual_seed(seed)
    nets = [cfg.build_generator("g_a", gen), cfg.build_generator("g_b", gen),
            cfg.build_discriminator("d_a", gen), cfg.build_discriminator("d_b", gen)]
    if dev.type == "cuda":
        nets = [n.to(dev, memory_format=_CL) for n in nets]
    g_a, g_b, d_a, d_b = (n.train() for n in nets)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    for m in itertools.chain(g_a.modules(), g_b.modules()):
        if isinstance(m, Dropout):
            m.generator = drop_gen
    patch_shape = tuple(int(p) for p in patch_shape)
    return CycleGANState(
        cfg=cfg, patch_shape=patch_shape, g_a=g_a, g_b=g_b, d_a=d_a, d_b=d_b,
        opt_g=_adam(itertools.chain(g_a.parameters(), g_b.parameters()), cfg.beta1),
        opt_d=_adam(itertools.chain(d_a.parameters(), d_b.parameters()), cfg.beta1),
        pool_fake_a=ImagePool(cfg.pool_size, (cfg.input_nc, *patch_shape), cfg.dtype, dev),
        pool_fake_b=ImagePool(cfg.pool_size, (cfg.output_nc, *patch_shape), cfg.dtype, dev),
        generator=gen, dropout_generator=drop_gen, device=dev)


def _average_over_ranks(grads, axes) -> None:
    """Sum the gradients over every shard axis, one flat float32 bucket per
    call, and divide by the number of ranks; in place."""
    live = [g for g in grads if g is not None]
    if not axes or not live:
        return
    flat = torch.cat([g.reshape(-1) for g in live])
    ranks = 1
    for axis in axes:
        all_reduce_(flat, axis.group)
        ranks *= axis.size
    flat /= ranks
    offset = 0
    for g in live:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def _optimizer_step(opt: torch.optim.Adam, loss: torch.Tensor, lr: float, axes=()) -> None:
    # Gradients of the optimizer's own parameters only; a norm-dead bias is
    # not in the graph and keeps .grad None, which Adam skips.
    params = [p for group in opt.param_groups for p in group["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    _average_over_ranks(grads, axes)
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _checkpointed(segment: nn.Module, x: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """``segment(x)`` with its activations recomputed in the backward
    instead of kept. ``checkpoint``'s preserve_rng_state covers the default
    generators only, so the dropout generator is put back at its state of
    the first forward for the recompute, and left afterwards where that
    forward left it: the recompute draws the same masks, and the stream goes
    on as without remat. The recompute runs the whole segment (no early
    stop), so its norms launch once more in every backward. It runs in the
    backward, after the shard context has closed, so it runs in a copy of
    the context of the first forward: a sharded segment recomputes with its
    halos and its whole-volume statistics, and its collectives come in the
    same order on every rank."""
    start = generator.get_state()
    first = [True]
    context = contextvars.copy_context()

    def run(inp):
        if first[0]:
            first[0] = False
            return segment(inp)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return context.run(segment, inp)
        finally:
            generator.set_state(now)

    with torch_checkpoint.set_checkpoint_early_stop(False):
        return torch_checkpoint.checkpoint(run, x, use_reentrant=False)


def make_train_step(cfg: CycleGANConfig):
    """step(state, real_a, real_b, lr, pool_draws=None) -> (state, metrics).

    real_a (B, input_nc, D, H, W) and real_b (B, output_nc, D, H, W) in
    [-1, 1], on any device; they are cast to the compute dtype on the
    state's device. ``state`` is updated in place and returned. After the
    step every parameter's ``.grad`` holds the raw gradient the step applied
    (None for the norm-dead biases). ``metrics`` maps the JAX package's ten
    names (G_A, G_B, cycle_A, cycle_B, idt_A, idt_B, cor_coe_GA, cor_coe_GB,
    D_A, D_B) to float32 scalars on the device; nothing is read back to the
    host. ``pool_draws`` = {"fake_a": (p, slot), "fake_b": (p, slot)}
    replaces the pools' own draws (tests), one per image of the global
    batch.

    Called inside a shard context, the step is one rank's part of the
    parallel step (module docstring): real_a and real_b are the rank's
    rows, or depth shards, and the metrics the global values."""
    lam_idt = cfg.lambda_identity
    # instance norm and none are per sample: independent applies stack
    fuse = cfg.norm in ("instance", "none")

    def g_loss(s: CycleGANState, real_a, real_b):
        bsz = real_a.shape[0]

        def g_a(x):
            return apply_g(s, s.g_a, x)

        def g_b(x):
            return apply_g(s, s.g_b, x)

        if not fuse:  # one apply per output, in JAX's order
            fake_b = g_a(real_a)
            rec_a = g_b(fake_b)
            fake_a = g_b(real_b)
            rec_b = g_a(fake_a)
            if lam_idt > 0:
                idt_a, idt_b = g_a(real_b), g_b(real_a)
        else:
            if lam_idt > 0:
                out_a1 = g_a(torch.cat([real_a, real_b]))
                fake_b, idt_a = out_a1[:bsz], out_a1[bsz:]
                out_b1 = g_b(torch.cat([real_b, real_a]))
                fake_a, idt_b = out_b1[:bsz], out_b1[bsz:]
            else:
                fake_b, fake_a = g_a(real_a), g_b(real_b)
            rec_a, rec_b = g_b(fake_b), g_a(fake_a)
        m = {"G_A": gan_loss(apply_d(s.d_a, fake_b), True, cfg.gan_mode),
             "G_B": gan_loss(apply_d(s.d_b, fake_a), True, cfg.gan_mode),
             "cycle_A": l1_loss(rec_a, real_a) * cfg.lambda_a,
             "cycle_B": l1_loss(rec_b, real_b) * cfg.lambda_b}
        if lam_idt > 0:
            m["idt_A"] = l1_loss(idt_a, real_b) * cfg.lambda_b * lam_idt
            m["idt_B"] = l1_loss(idt_b, real_a) * cfg.lambda_a * lam_idt
        else:
            m["idt_A"] = m["idt_B"] = torch.zeros((), device=real_a.device)
        loss = sum(m.values())
        fake_a, fake_b = fake_a.detach(), fake_b.detach()
        with torch.no_grad():  # logged, not optimized
            m["cor_coe_GA"] = cor_coe_loss(fake_b, real_a) * cfg.lambda_co_a
            m["cor_coe_GB"] = cor_coe_loss(fake_a, real_b) * cfg.lambda_co_b
        return loss, fake_a, fake_b, m

    def apply_d(d: nn.Module, x: torch.Tensor) -> torch.Tensor:
        # depth shards are gathered; the discriminator runs on whole volumes
        sp = spatial_shard_info()
        with param_casts(d, cfg.dtype):
            if sp is None:
                return d(x)
            xg = all_gather(x, sp.group, dim=2)
            with spatial_unsharded():
                return d(xg)

    def apply_g(s: CycleGANState, g: nn.Module, x: torch.Tensor) -> torch.Tensor:
        with param_casts(g, cfg.dtype):
            if not cfg.remat:
                return g(x)
            for segment in remat_segments(g):
                x = _checkpointed(segment, x, s.dropout_generator)
            return x

    def d_loss(s: CycleGANState, real_a, real_b, fake_a, fake_b):
        # 0.5 * (gan(D(real), 1) + gan(D(pooled fake), 0)) per D, real and
        # fake stacked into one apply where the norm allows
        bsz = real_a.shape[0]
        out = {}
        for name, d, real, fake in (("D_A", s.d_a, real_b, fake_b),
                                    ("D_B", s.d_b, real_a, fake_a)):
            if fuse:
                pred = apply_d(d, torch.cat([real, fake]))
                pred_real, pred_fake = pred[:bsz], pred[bsz:]
            else:
                pred_real, pred_fake = apply_d(d, real), apply_d(d, fake)
            out[name] = 0.5 * (gan_loss(pred_real, True, cfg.gan_mode)
                               + gan_loss(pred_fake, False, cfg.gan_mode))
        return out["D_A"] + out["D_B"], out

    def prepare(s: CycleGANState, x: torch.Tensor) -> torch.Tensor:
        x = x.to(s.device, cfg.dtype)
        return x.contiguous(memory_format=_CL) if x.is_cuda else x

    def query(s: CycleGANState, pool: ImagePool, fakes: torch.Tensor, draws):
        # over a split batch every rank queries with the global batch's
        # fakes and the same draws, and keeps its rows
        dp = data_shard_info()
        if dp is None:
            return pool_query(pool, fakes, s.generator, draws)
        rows = fakes.shape[0]
        everyone = torch.cat(all_gather_stacked(fakes, dp.group).unbind(0))
        mixed = pool_query(pool, everyone, s.generator, draws)
        return mixed[dp.index * rows:(dp.index + 1) * rows]

    def train_step(state: CycleGANState, real_a: torch.Tensor, real_b: torch.Tensor,
                   lr: float, pool_draws: Optional[dict] = None):
        real_a, real_b = prepare(state, real_a), prepare(state, real_b)
        draws = pool_draws or {}
        axes = shard_axes()
        loss, fake_a, fake_b, metrics = g_loss(state, real_a, real_b)
        _optimizer_step(state.opt_g, loss, lr, axes)
        fake_b = query(state, state.pool_fake_b, fake_b, draws.get("fake_b"))
        fake_a = query(state, state.pool_fake_a, fake_a, draws.get("fake_a"))
        loss, d_metrics = d_loss(state, real_a, real_b, fake_a, fake_b)
        _optimizer_step(state.opt_d, loss, lr, axes)
        metrics.update(d_metrics)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


class GenerateFn:
    """A generator bound to its device and compute dtype. ``fn(x)`` takes
    (B, C, D, H, W), casts it to the compute dtype on the generator's device
    and runs the forward under ``torch.inference_mode()``; the output is in
    the compute dtype."""

    def __init__(self, net: nn.Module, dtype: torch.dtype, device: torch.device):
        self.net, self.dtype, self.device = net, dtype, device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.net(x.to(self.device, self.dtype))


def make_generate_fn(cfg: CycleGANConfig, which: str = "g_a",
                     device: Optional[Union[str, torch.device]] = None,
                     seed: int = 0) -> GenerateFn:
    """Build generator ``which`` (weights from ``seed``; load real ones into
    ``.net`` with checkpoint.load_reference_pth or load_state_dict), in eval
    mode on ``device`` (CUDA by default; channels_last_3d there)."""
    dev = resolve_device(device)
    set_conv_precision(cfg.dtype)
    net = cfg.build_generator(which, torch.Generator().manual_seed(seed)).eval()
    if dev.type == "cuda":
        net = net.to(dev, memory_format=torch.channels_last_3d)
    return GenerateFn(net, cfg.dtype, dev)
