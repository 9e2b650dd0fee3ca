"""The rank side of the port's parallel tests (tests/test_torch_port_parallel_*.py):
``spawn_ranks`` starts R CPU processes joined by gloo over a FileStore, and
the ``rank_*`` functions are what each rank runs. This module imports the
port only, never JAX, so that a spawned rank starts quickly; the test files
hold the JAX side and the one-device port side in the test process."""
from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 120.0


def _rank_main(rank: int, world: int, tmp: str, fn, args):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    from mra_gan_tpu_torch.core.mesh import init_distributed

    init_distributed("cpu", "gloo", os.path.join(tmp, "store"), rank, world, timeout_s=90)
    import torch.distributed as dist

    try:
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world: int, tmp_path, *args, timeout_s: float = SPAWN_TIMEOUT_S):
    """Start ``fn(rank, world, *args)`` on ``world`` spawned CPU ranks (gloo,
    FileStore in ``tmp_path``, one thread each) and return a function that
    waits for them and returns their results in rank order; the caller can
    work meanwhile (the JAX side of a test). A rank that fails, or a run
    past ``timeout_s`` from the start, raises, and every rank is ended."""
    tmp = Path(tmp_path) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s

    def results() -> list:
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks took over "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return results


def spawn_ranks(fn, world: int, tmp_path, *args, timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """``start_ranks`` and wait: the ranks' results in rank order."""
    return start_ranks(fn, world, tmp_path, *args, timeout_s=timeout_s)()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# collectives and halos


def rank_halos(rank: int, world: int, x: np.ndarray, cot: np.ndarray, lo: int, hi: int,
               boundary: str, xc: np.ndarray, weight: np.ndarray):
    """neighbour_exchange of this rank's depth shard of x (float64) with its
    backward for the cotangent ``cot`` of the extended shards (the whole
    (N, C, D + world (lo + hi), H, W) stack, rank-major), and halo_conv3d of
    this rank's depth shard of xc with ``weight``."""
    from mra_gan_tpu_torch.core.mesh import DATA_AXIS, make_mesh
    from mra_gan_tpu_torch.parallel.collectives import neighbour_exchange
    from mra_gan_tpu_torch.parallel.spatial import halo_conv3d

    mesh = make_mesh()
    d = x.shape[2] // world
    xs = torch.from_numpy(x[:, :, rank * d:(rank + 1) * d].copy()).requires_grad_(True)
    ext = neighbour_exchange(xs, lo, hi, boundary, mesh.group(DATA_AXIS))
    e = d + lo + hi
    ext.backward(torch.from_numpy(cot[:, :, rank * e:(rank + 1) * e].copy()))
    dc = xc.shape[2] // world
    conv = halo_conv3d(mesh, torch.from_numpy(xc[:, :, rank * dc:(rank + 1) * dc].copy()),
                       torch.from_numpy(weight))
    return {"ext": _np(ext), "grad": _np(xs.grad), "conv": _np(conv)}


# ---------------------------------------------------------------------------
# the sharded norm


def rank_norms(rank: int, world: int, x: np.ndarray, g: np.ndarray, acts):
    """For each act: the sharded norm's forward of this rank's depth shard of
    x (inside spatial_sharding) and its backward for g's shard, float32."""
    from mra_gan_tpu_torch.core.spatial_ctx import spatial_sharding
    from mra_gan_tpu_torch.ops.norm import instance_norm_act

    d = x.shape[2] // world
    part = slice(rank * d, (rank + 1) * d)
    out = {}
    for act in acts:
        xs = torch.from_numpy(x[:, :, part].copy()).requires_grad_(True)
        with spatial_sharding():
            y = instance_norm_act(xs, act=act)
        y.backward(torch.from_numpy(g[:, :, part].copy()))
        out[act] = (_np(y), _np(xs.grad))
    return out


# ---------------------------------------------------------------------------
# decodes


def _generate_fn(cfg_fields: dict, state_dict: dict):
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, make_generate_fn

    cfg = CycleGANConfig(**cfg_fields, dtype=torch.float32)
    gen = make_generate_fn(cfg, "g_a", device="cpu")
    gen.net.load_state_dict(state_dict)
    return gen


def rank_sharded_apply(rank: int, world: int, cases):
    """``sharded_generator_apply`` of each (config fields, generator state
    dict, (D, H, W) volume) case over all ranks."""
    from mra_gan_tpu_torch.core.mesh import make_mesh
    from mra_gan_tpu_torch.parallel.spatial import sharded_generator_apply

    mesh = make_mesh()
    return [sharded_generator_apply(mesh, _generate_fn(f, sd), vol) for f, sd, vol in cases]


def rank_sliding_window(rank: int, world: int, cfg_fields: dict, state_dict: dict,
                        vol: np.ndarray, kwargs: dict):
    """``sharded_sliding_window`` of the generator over all ranks."""
    from mra_gan_tpu_torch.core.mesh import make_mesh
    from mra_gan_tpu_torch.parallel.spatial import sharded_sliding_window

    return sharded_sliding_window(make_mesh(), vol, _generate_fn(cfg_fields, state_dict),
                                  **kwargs)


# ---------------------------------------------------------------------------
# train steps


def _grads(state) -> dict:
    return {name: {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}
            for name, net in state.nets.items()}


def rank_steps(rank: int, world: int, common: dict, patch, nets: dict, batches, draws,
               data: int, space: int, lr: float, bad_batches=()):
    """The port's parallel step on a (data, space) grid: the data-parallel
    step for space 1, else the spatial step (2-D for data > 1), from the
    given weights, over the global ``batches`` (B, C, D, H, W) with the
    pools fed ``draws``. Returns the metrics of each step, the gradients of
    step 0 (summed over the ranks, averaged), the state dicts and pool
    counts afterwards, and the ValueError text of each of ``bad_batches``."""
    from mra_gan_tpu_torch.core.mesh import DATA_AXIS, SPACE_AXIS, make_mesh
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, create_state
    from mra_gan_tpu_torch.parallel.sharding import make_sharded_train_step, shard_state
    from mra_gan_tpu_torch.parallel.spatial import make_spatial_train_step, shard_spatial_state

    cfg = CycleGANConfig(**common, dtype=torch.float32)
    state = create_state(cfg, 0, tuple(patch), device="cpu")
    for name, net in state.nets.items():
        net.load_state_dict(nets[name])
    mesh = make_mesh(data, space)
    if space == 1:
        state = shard_state(state, mesh)
        step, take = make_sharded_train_step(cfg, mesh)
    else:
        state = shard_spatial_state(state, mesh, SPACE_AXIS)
        step, take = make_spatial_train_step(cfg, mesh, SPACE_AXIS,
                                             DATA_AXIS if data > 1 else None)
    metrics, grads = [], None
    for k, (a, b) in enumerate(batches):
        _, m = step(state, take(torch.from_numpy(a)), take(torch.from_numpy(b)), lr,
                    pool_draws=draws[k] if draws else None)
        metrics.append({n: float(v) for n, v in m.items()})
        if k == 0:
            grads = _grads(state)
    errors = []
    for a in bad_batches:
        try:
            take(torch.from_numpy(a))
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return {"metrics": metrics, "grads": grads,
            "params": {n: net.state_dict() for n, net in state.nets.items()},
            "counts": (state.pool_fake_a.count, state.pool_fake_b.count), "errors": errors}


# ---------------------------------------------------------------------------
# the CLIs


def rank_train_main(rank: int, world: int, argv):
    """``python -m mra_gan_tpu_torch.train`` on this rank (the group joined):
    the driver's epochs and the final parameters (None on an idle rank)."""
    from mra_gan_tpu_torch import train

    out = train.main(list(argv))
    state = out["state"]
    return {"epochs": out["epochs"],
            "params": None if state is None else
            {n: net.state_dict() for n, net in state.nets.items()},
            "step": None if state is None else state.step}


def rank_train_preflight(rank: int, world: int, argv, oom_rank: int, inside: bool = False):
    """``train.main`` with the preflight reading a peak of (rank + 1) GiB
    after the trial steps, or, on ``oom_rank``, running out of memory after
    them, or with ``inside`` at the start of its first trial step, before
    the step's first collective, which its peers enter: {'exit': the
    SystemExit's text or None, 'est': what each preflight call returned,
    'seconds': how long the preflight took to end}."""
    from mra_gan_tpu_torch import train
    from mra_gan_tpu_torch.core import memory

    def reader(trial):
        trial()
        if rank == oom_rank and not inside:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return (rank + 1) << 30

    def out_of_memory(*args, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    est, seconds = [], []

    def preflight(step, *args, **kw):
        t0 = time.monotonic()
        try:
            est.append(memory.preflight(out_of_memory if inside and rank == oom_rank else step,
                                        *args, peak_reader=reader, **kw))
        finally:
            seconds.append(time.monotonic() - t0)
        return est[-1]

    train.preflight = preflight
    try:
        train.main(list(argv))
    except SystemExit as e:
        return {"exit": str(e), "est": est, "seconds": seconds}
    return {"exit": None, "est": est, "seconds": seconds}


def rank_decode_main(rank: int, world: int, argv):
    """``python -m mra_gan_tpu_torch.test`` on this rank: its return value."""
    from mra_gan_tpu_torch import test

    return test.main(list(argv))


def rank_remat_backward(rank: int, world: int, sd: dict, x: np.ndarray):
    """A resnet generator's forward on this rank's depth shard of x inside
    ``spatial_sharding``, plain and through the remat segments, then the
    backward of sum(y^2) after the context has closed (as a CUDA autograd
    thread runs it): the input gradient and the parameter gradients."""
    from mra_gan_tpu_torch.core.spatial_ctx import spatial_sharding
    from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, _checkpointed
    from mra_gan_tpu_torch.models.networks import remat_segments

    d = x.shape[2] // world
    out = []
    for remat in (False, True):
        net = CycleGANConfig(ngf=4, dtype=torch.float32).build_generator()
        net.load_state_dict(sd)
        xs = torch.from_numpy(x[:, :, rank * d:(rank + 1) * d].copy()).requires_grad_(True)
        gen = torch.Generator().manual_seed(0)
        with spatial_sharding():
            y = xs
            for segment in (remat_segments(net) if remat else [net]):
                y = _checkpointed(segment, y, gen) if remat else segment(y)
        y.square().sum().backward()
        out.append((xs.grad, {k: p.grad for k, p in net.named_parameters()
                              if p.grad is not None}))
    return out


# ---------------------------------------------------------------------------
# the rank view of the loader and the driver


def rank_loader_views(rank: int, world: int, cases):
    """For each case (a dict: data, cache, pipeline, num_samples, batch,
    workers, seed, patch, mesh (data, space)): this rank's rows of the mesh's
    data axis, as the driver takes them; its rank view's batches of epoch 0
    on the case's cache, cold (every rank writing it at once), and, after
    every rank has flushed its writes, of epoch 1, warm; and each
    (epoch, volume, kept samples or None) its dataset's sample_patches was
    called for."""
    import torch.distributed as dist

    from mra_gan_tpu_torch.core.mesh import DATA_AXIS, make_mesh
    from mra_gan_tpu_torch.data.dataset import (PatchLoader, UnpairedVolumeDataset,
                                                flush_cache_writes)
    from mra_gan_tpu_torch.parallel.sharding import data_rows

    class Counted(UnpairedVolumeDataset):
        def sample_patches(self, idx, epoch=0, keep=None):
            self.calls.append((epoch, idx, None if keep is None else list(keep)))
            return super().sample_patches(idx, epoch, keep)

    meshes, out = {}, []
    for case in cases:
        grid = tuple(case["mesh"])
        if grid not in meshes:  # every rank makes the same meshes in the same order
            meshes[grid] = make_mesh(*grid)
        rows = data_rows(case["batch"], meshes[grid].axis(DATA_AXIS))
        ds = Counted(case["data"], patch_size=case["patch"], pipeline=case["pipeline"],
                     num_samples=case["num_samples"],
                     shuffle_labels=case["pipeline"] == "legacy", cache_dir=case["cache"],
                     seed=case["seed"])
        ds.calls = []
        loader = PatchLoader(ds, batch_size=case["batch"], workers=case["workers"],
                             rows=(rows.start, rows.stop))
        epochs = []
        for epoch in (0, 1):
            epochs.append(list(loader.epoch(epoch)))
            flush_cache_writes()
            dist.barrier()
        out.append({"rows": (rows.start, rows.stop), "epochs": epochs, "calls": ds.calls,
                    "steps": loader.steps_per_epoch()})
    return out


def rank_train_views(rank: int, world: int, runs: dict):
    """Each run (tag -> argv without --name) of ``train.main`` on this rank
    twice: with its rank view, as the driver is, under --name {tag}_rank,
    and with the global view, ``train.rank_rows`` patched to None (every
    rank loads and augments the whole global batch and takes its part),
    under --name {tag}_global. For each: the inputs its step was given and
    the final parameters."""
    from mra_gan_tpu_torch import train

    factories = {n: getattr(train, n) for n in ("rank_rows", "make_sharded_train_step",
                                                "make_spatial_train_step")}

    def recording(factory, inputs):
        def make(*args, **kw):
            step, take = factory(*args, **kw)

            def step_and_record(state, real_a, real_b, lr, pool_draws=None):
                inputs.append((_np(real_a), _np(real_b)))
                return step(state, real_a, real_b, lr, pool_draws)

            return step_and_record, take

        return make

    out = {}
    for tag, argv in runs.items():
        for view in ("rank", "global"):
            inputs = []
            if view == "global":
                train.rank_rows = lambda opt, mesh: None
            for name in ("make_sharded_train_step", "make_spatial_train_step"):
                setattr(train, name, recording(factories[name], inputs))
            try:
                res = train.main([*argv, "--name", f"{tag}_{view}"])
            finally:
                for name, f in factories.items():
                    setattr(train, name, f)
            out[f"{tag} {view}"] = {
                "inputs": inputs, "step": res["state"].step,
                "params": {n: net.state_dict() for n, net in res["state"].nets.items()}}
    return out
