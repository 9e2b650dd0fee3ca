"""Checkpoints of the port's CycleGAN train state (counterpart of
``CheckpointManager``, mra_gan_tpu/checkpoint/io.py:24-170).

``<checkpoints_dir>/<name>/ckpt_{epoch}.pt`` is one ``torch.save`` of plain
containers (``state_to_dict``): a format tag, the ``CycleGANConfig`` fields
(the dtype by name) and the patch shape; the four networks' and both Adam
chains' state dicts; both image pools (images NCDHW, count); the states of
the pools' generator and of the dropout generator; and the step. Every
tensor is on the CPU in its standard layout, so a file reads back on any
device. Each ``save`` also writes the reference's per-network files
``{epoch}_net_{G_A,G_B,D_A,D_B}.pth`` beside it (checkpoint.io
``save_reference_pth``), so the decode CLI reads a port-trained run as it
is. Every file is written under a temporary name and then renamed over the
old one, so a crash mid-save leaves the previous ``latest`` whole.

``restore`` loads the saved tensors into a state built from the live
configuration, as the JAX driver restores its saved tree into a state made
from the flags (train.py:172-178). It refuses, with a ValueError naming the
first misfit and leaving the state untouched, only what the state's tensors
cannot take: a network field (channels, widths, architectures, norm,
dropout, the Dynet's sizes and spacings), the patch shape, the pool size,
or a tensor's shape. The objective (``gan_mode``, the lambdas), ``beta1`` and the compute dtype are
the live state's: the saved pool images are cast to its dtype, and Adam
keeps its live betas. A dropout generator saved on another device type is
refused only where the configuration builds dropout; without dropout it is
never drawn from, and the live one is kept. The JAX package falls back to
resetting a pool whose layout differs (single-chip cell layout against the
spatial step's plain one, :55-150); the port stores its pools in one layout
only, so it has no such fallback.

A parallel run saves in this same format. The depth-sharded pools of the
spatial step (``state.pool_shard``) are all-gathered along depth, so
``state_to_dict``, and with it ``save``, is collective over the shard
group; only rank 0 of the default group writes the files. ``restore`` on a
sharded state takes each rank's depth shard of the saved pools, so a
checkpoint of any run restores into any layout.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Union

import torch
import torch.distributed as dist

from ..models.cycle_gan import CycleGANConfig, CycleGANState
from ..parallel.collectives import all_gather_stacked
from .io import reference_state_dict

FORMAT = "mra_gan_tpu_torch.cycle_gan_state/1"
# The config fields that decide the state's tensors: the networks' and the
# pools'. The others (the objective, beta1, the init, the compute dtype) are
# taken from the live state on restore.
STRUCTURE_FIELDS = ("input_nc", "output_nc", "ngf", "ndf", "net_g", "net_d", "n_layers_d",
                    "norm", "no_dropout", "pool_size", "dynet_sizes", "dynet_spacings")
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(CycleGANConfig)}
# (reference file suffix, state attribute)
NET_FILES = (("G_A", "g_a"), ("G_B", "g_b"), ("D_A", "d_a"), ("D_B", "d_b"))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def config_to_dict(cfg: CycleGANConfig) -> dict:
    """The config's fields, the dtype by name ('bfloat16', 'float32'), the
    Dynet's sizes and spacings as tuples of int and float."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    out["dynet_sizes"] = tuple(int(v) for v in cfg.dynet_sizes)
    out["dynet_spacings"] = tuple(float(v) for v in cfg.dynet_spacings)
    return out


def config_from_dict(fields: dict) -> CycleGANConfig:
    """The config of ``config_to_dict``'s form; a field that a checkpoint of
    an earlier version lacks takes its default."""
    return CycleGANConfig(**{**fields, "dtype": _DTYPES[fields["dtype"]]})


def _cpu(t: torch.Tensor) -> torch.Tensor:
    """A copy on the CPU in the standard layout (never the tensor itself, so
    the state can go on training while the copy is written)."""
    return t.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)


def _optimizer_to_dict(opt: torch.optim.Optimizer) -> dict:
    sd = opt.state_dict()
    return {"state": {i: {k: _cpu(v) if torch.is_tensor(v) else v for k, v in s.items()}
                      for i, s in sd["state"].items()},
            "param_groups": sd["param_groups"]}


def _whole_pool(state: CycleGANState, images: torch.Tensor) -> torch.Tensor:
    # a sharded pool's images gathered along depth (collective), else itself
    if state.pool_shard is None:
        return images
    return torch.cat(all_gather_stacked(images, state.pool_shard.group).unbind(0), dim=2)


def _pool_part(state: CycleGANState, images: torch.Tensor) -> torch.Tensor:
    # this rank's depth shard of whole pool images
    axis = state.pool_shard
    if axis is None:
        return images
    rows = images.shape[2] // axis.size
    return images[:, :, axis.index * rows:(axis.index + 1) * rows]


def is_writer() -> bool:
    """Whether this process writes a run's files: rank 0 of a joined
    process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def state_to_dict(state: CycleGANState) -> dict:
    """What ``ckpt_{epoch}.pt`` holds: plain containers of CPU tensors, copies
    of the state's, the pools whole (collective for a sharded state)."""
    return {
        "format": FORMAT,
        "config": config_to_dict(state.cfg),
        "patch_shape": list(state.patch_shape),
        "nets": {name: {k: _cpu(v) for k, v in net.state_dict().items()}
                 for name, net in state.nets.items()},
        "opt_g": _optimizer_to_dict(state.opt_g),
        "opt_d": _optimizer_to_dict(state.opt_d),
        "pool_fake_a": {"images": _cpu(_whole_pool(state, state.pool_fake_a.images)),
                        "count": state.pool_fake_a.count},
        "pool_fake_b": {"images": _cpu(_whole_pool(state, state.pool_fake_b.images)),
                        "count": state.pool_fake_b.count},
        "generator": state.generator.get_state(),
        "dropout_generator": {"device": state.dropout_generator.device.type,
                              "state": state.dropout_generator.get_state()},
        "step": int(state.step),
    }


def _atomic_save(obj, path: Path) -> None:
    """torch.save to a temporary file in ``path``'s directory, flushed to
    disk, then renamed to ``path``."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _write_reference_files(state: CycleGANState, directory: Union[str, Path], epoch) -> None:
    """The four reference files ``{epoch}_net_{G_A,G_B,D_A,D_B}.pth`` of
    ``state``'s networks in ``directory``, each written as ``save_reference_pth``
    writes it."""
    cfg = state.cfg
    for suffix, name in NET_FILES:
        arch = cfg.net_g if name.startswith("g") else cfg.net_d
        _atomic_save(reference_state_dict(state.nets[name], arch, not cfg.no_dropout),
                     Path(directory) / f"{epoch}_net_{suffix}.pth")


def _check_shapes(what: str, saved: dict, live: dict) -> None:
    if set(saved) != set(live):
        raise ValueError(f"checkpoint {what} has keys {sorted(set(saved) - set(live))[:4]} that "
                         f"this state lacks and lacks {sorted(set(live) - set(saved))[:4]}")
    for k, v in live.items():
        if tuple(saved[k].shape) != tuple(v.shape):
            raise ValueError(f"checkpoint {what}.{k} has shape {tuple(saved[k].shape)}, this "
                             f"state's {tuple(v.shape)}")


def _check(raw: dict, state: CycleGANState) -> None:
    """Raise ValueError naming the first thing of ``raw`` that does not fit
    ``state``."""
    if raw.get("format") != FORMAT:
        raise ValueError(f"not a checkpoint of this format: format {raw.get('format')!r}, "
                         f"expected {FORMAT!r}")
    live = config_to_dict(state.cfg)
    for k in STRUCTURE_FIELDS:
        saved = raw["config"].get(k, _DEFAULTS[k])
        if saved != live[k]:
            raise ValueError(f"checkpoint config field {k!r} is {saved!r}, "
                             f"this state's {live[k]!r}")
    if tuple(raw["patch_shape"]) != tuple(state.patch_shape):
        raise ValueError(f"checkpoint patch_shape is {tuple(raw['patch_shape'])}, this "
                         f"state's {tuple(state.patch_shape)}")
    for name, net in state.nets.items():
        _check_shapes(f"nets.{name}", raw["nets"][name], net.state_dict())
    for name in ("opt_g", "opt_d"):
        params = [p for g in getattr(state, name).param_groups for p in g["params"]]
        saved = raw[name]
        n_saved = sum(len(g["params"]) for g in saved["param_groups"])
        if n_saved != len(params):
            raise ValueError(f"checkpoint {name} holds {n_saved} parameters, this state's "
                             f"{len(params)}")
        for i, s in saved["state"].items():
            for k, v in s.items():
                if torch.is_tensor(v) and v.dim() > 0 and tuple(v.shape) != tuple(params[i].shape):
                    raise ValueError(f"checkpoint {name}.state.{i}.{k} has shape "
                                     f"{tuple(v.shape)}, its parameter's {tuple(params[i].shape)}")
    for name in ("pool_fake_a", "pool_fake_b"):
        _check_shapes(name, {"images": _pool_part(state, raw[name]["images"])},
                      {"images": getattr(state, name).images})
    if raw["generator"].numel() != state.generator.get_state().numel():
        raise ValueError("checkpoint generator state does not fit this state's pool generator")
    drop = raw["dropout_generator"]
    if not state.cfg.no_dropout and drop["device"] != state.dropout_generator.device.type:
        raise ValueError(f"checkpoint dropout_generator is a {drop['device']} generator, this "
                         f"state's a {state.dropout_generator.device.type} one: a generator's "
                         f"state does not carry over between device types")


def relayout_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Lay every optimizer state tensor of a parameter's shape out as the
    parameter is (channels_last_3d on CUDA): ``Optimizer.load_state_dict``
    moves the saved tensors with ``.to(device)``, which keeps their own
    layout, not the parameter's."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape == p.shape and v.stride() != p.stride():
                    st[k] = torch.empty_like(p, dtype=v.dtype).copy_(v)


def load_state(state: CycleGANState, raw: dict) -> CycleGANState:
    """Load ``state_to_dict``'s containers into ``state`` in place, under the
    live beta1 and dtype, and return it."""
    with torch.no_grad():
        for name, net in state.nets.items():
            net.load_state_dict(raw["nets"][name], strict=True)
        for name in ("opt_g", "opt_d"):
            opt = getattr(state, name)
            betas = [g["betas"] for g in opt.param_groups]
            opt.load_state_dict(raw[name])
            for g, b in zip(opt.param_groups, betas):  # the live beta1
                g["betas"] = b
            relayout_optimizer_state(opt)
        for name in ("pool_fake_a", "pool_fake_b"):
            pool = getattr(state, name)
            pool.images.copy_(_pool_part(state, raw[name]["images"]))  # to the live dtype
            pool.count = int(raw[name]["count"])
    state.generator.set_state(raw["generator"])
    drop = raw["dropout_generator"]
    if drop["device"] == state.dropout_generator.device.type:
        state.dropout_generator.set_state(drop["state"])
    state.step = int(raw["step"])
    return state


class CheckpointManager:
    """``CheckpointManager(checkpoints_dir, name)`` keeps a run's checkpoints
    under ``root = <checkpoints_dir>/<name>/``: ``ckpt_{epoch}.pt`` and a
    ``latest`` alias, each with its four reference ``.pth`` files."""

    def __init__(self, checkpoints_dir: Union[str, Path], name: str):
        self.root = Path(checkpoints_dir).resolve() / name
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, epoch) -> Path:
        return self.root / f"ckpt_{epoch}.pt"

    def save(self, epoch, state: CycleGANState, also_latest: bool = True) -> None:
        """Write ``ckpt_{epoch}.pt`` and ``{epoch}_net_*.pth``, and the same
        as ``latest`` unless ``also_latest`` is False or ``epoch`` is
        'latest' itself. Collective for a sharded state (every rank calls
        it); only rank 0 writes."""
        raw = state_to_dict(state)
        if not is_writer():
            return
        epochs = [epoch] + (["latest"] if also_latest and str(epoch) != "latest" else [])
        for e in epochs:
            _atomic_save(raw, self.path(e))
            _write_reference_files(state, self.root, e)

    def restore(self, epoch, state: CycleGANState) -> CycleGANState:
        """Load ``ckpt_{epoch}.pt`` into ``state`` (made by ``create_state``
        with the same networks, pool size and patch shape, any seed), on its
        device, and return it: ``make_train_step(state.cfg)``'s step goes on
        from it as from the state that was saved, under the live objective,
        beta1 and dtype."""
        raw = self.restore_raw(epoch)
        _check(raw, state)
        return load_state(state, raw)

    def restore_raw(self, epoch) -> dict:
        """The saved containers as they are (``state_to_dict``'s form), on the
        CPU."""
        p = self.path(epoch)
        if not p.exists():
            raise FileNotFoundError(f"no checkpoint at {p}")
        return torch.load(p, map_location="cpu", weights_only=True)

    def has(self, epoch) -> bool:
        return self.path(epoch).exists()
