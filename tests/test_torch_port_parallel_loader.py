"""Data parallelism's rank view (mra_gan_tpu_torch/data/dataset.py
``PatchLoader(rows=...)``, data/augment.py ``augment_batch(rows=...)``, the
driver's ``rank_rows``) on gloo ranks of the CPU
(tests/torch_port_parallel_ranks.py), at 16^3:

- each rank's batches, cold and then warm on a cache the ranks share and
  write at once, bit-equal to its rows of the JAX package's global batches
  at the same seed (``take`` of them), over 2 and 4 data ranks and the
  2 x 2 grid, the legacy and monai pipelines, num_samples 2 with rows of
  one, two and three (a volume straddling two ranks), workers 0, 1 and 4;
- each rank's ``sample_patches`` calls: exactly the volumes behind its
  rows, each with only its samples, a straddled volume by both ranks;
- ``python -m mra_gan_tpu_torch.train`` with the rank view against the
  global view (every rank loading and augmenting the whole batch, then
  taking its part): the step inputs, the final parameters and the
  --dump_patches files bit-equal, with --augment, on 2 and 4 ranks and the
  2 x 2 grid;
- a volume short of num_samples refused by the rank view (in process)."""
from __future__ import annotations

import gzip

import numpy as np
import pytest

from mra_gan_tpu.data import dataset as jax_dataset
from mra_gan_tpu.data import native as jax_native
from torch_port_parallel_ranks import rank_loader_views, rank_train_views, start_ranks
from torch_port_util import write_train_data

VOLUMES = 6
PATCH = (16, 16, 16)
SEED = 5
# id -> (world, mesh (data, space), pipeline, num_samples, global batch, workers)
LOADER_CASES = {
    "dp2-monai-rows2-w0": (2, (2, 1), "monai", 2, 4, 0),
    "dp2-legacy-rows3-w1": (2, (2, 1), "legacy", 2, 6, 1),
    "dp2-monai-rows3-w4": (2, (2, 1), "monai", 2, 6, 4),
    "dp4-legacy-rows2-w4": (4, (4, 1), "legacy", 2, 8, 4),
    "dp4-monai-rows1-w1": (4, (4, 1), "monai", 2, 4, 1),
    "grid2x2-monai-rows3-w0": (4, (2, 2), "monai", 2, 6, 0),
    "grid2x2-legacy-rows2-w1": (4, (2, 2), "legacy", 2, 4, 1),
}
SMALL = ["--ngf", "4", "--ndf", "4", "--n_layers_D", "1", "--precision", "float32",
         "--niter", "1", "--niter_decay", "0", "--num_samples", "2", "--print_freq", "100",
         "--patch_size", *map(str, PATCH), "--seed", str(SEED), "--device", "cpu"]
# id -> (world, flags)
DRIVER_CASES = {
    "dp2-augment-dumps": (2, ["--data_parallel", "--augment", "--dump_patches", "3",
                              "--batch_size", "4", "--workers", "1"]),
    "dp4-rows1": (4, ["--data_parallel", "--batch_size", "4", "--workers", "4"]),
    "grid2x2-augment-rows3": (4, ["--data_parallel", "--spatial_parallel", "--space_devices",
                                  "2", "--augment", "--batch_size", "6", "--workers", "0"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups, started together: the loader cases, then the
    driver's views, in each group; the test process meanwhile makes the
    JAX global batches."""
    tmp = tmp_path_factory.mktemp("rank_views")
    data = write_train_data(tmp / "data", n=VOLUMES, shape=(20, 20, 20))
    waits = {}
    for world in (2, 4):
        cases = [dict(data=str(data), cache=str(tmp / f"cache_{cid}"), pipeline=p,
                      num_samples=ns, batch=b, workers=w, seed=SEED, patch=PATCH, mesh=mesh)
                 for cid, (wd, mesh, p, ns, b, w) in LOADER_CASES.items() if wd == world]
        drivers = {cid: ["--data_path", str(data), "--checkpoints_dir", str(tmp / "ck"),
                         *SMALL, *flags]
                   for cid, (wd, flags) in DRIVER_CASES.items() if wd == world}
        waits[world] = (start_ranks(rank_loader_views, world, tmp, cases, timeout_s=150),
                        start_ranks(rank_train_views, world, tmp, drivers, timeout_s=150))
    want = {cid: _jax_global(data, tmp / f"jax_{cid}", p, ns, b)
            for cid, (_, _, p, ns, b, _) in LOADER_CASES.items()}
    got = {}
    for world, (loaders, drivers) in waits.items():
        ids = [cid for cid, case in LOADER_CASES.items() if case[0] == world]
        per_rank = loaders()
        got.update({cid: [r[k] for r in per_rank] for k, cid in enumerate(ids)})
        got[f"drivers {world}"] = drivers()
    return {"loaders": got, "want": want, "ck": tmp / "ck", "caches": tmp}


def _jax_global(data, cache, pipeline, num_samples, batch):
    """The JAX package's loader, its pure-Python reader and numpy gather (the
    port's native path is bit-equal to them, tests/test_torch_port_native.py):
    each epoch's global batches and volume order."""
    saved = jax_native.available
    jax_native.available = lambda: False
    try:
        ds = jax_dataset.UnpairedVolumeDataset(
            data, patch_size=PATCH, pipeline=pipeline, num_samples=num_samples,
            shuffle_labels=pipeline == "legacy", cache_dir=str(cache), seed=SEED)
        loader = jax_dataset.PatchLoader(ds, batch_size=batch, workers=0)
        return [{"batches": list(loader.epoch(e)), "order": loader._volume_order(e)}
                for e in (0, 1)]
    finally:
        jax_native.available = saved


@pytest.mark.parametrize("cid", list(LOADER_CASES))
def test_rank_view_batches_equal_take_of_the_jax_global_batch(runs, cid):
    world, (nd, ns_space), *_ = LOADER_CASES[cid]
    want = runs["want"][cid]
    for rank, got in enumerate(runs["loaders"][cid]):
        lo, hi = got["rows"]
        per = LOADER_CASES[cid][4] // nd
        assert (lo, hi) == ((rank // ns_space) * per, (rank // ns_space + 1) * per)
        for epoch in (0, 1):  # cold, then warm
            mine, glob = got["epochs"][epoch], want[epoch]["batches"]
            assert len(mine) == len(glob) == got["steps"] > 0
            for (a, b), (ga, gb) in zip(mine, glob):
                assert a.shape == (hi - lo, *PATCH, 1)
                np.testing.assert_array_equal(a, ga[lo:hi])
                np.testing.assert_array_equal(b, gb[lo:hi])
    # the ranks raced on one cache entry per volume: each landed whole
    cache = runs["caches"] / f"cache_{cid}"
    assert not [p.name for p in cache.iterdir() if ".tmp" in p.name]


@pytest.mark.parametrize("cid", list(LOADER_CASES))
def test_rank_view_samples_only_the_volumes_behind_its_rows(runs, cid):
    world, (nd, ns_space), _, ns, batch, _ = LOADER_CASES[cid]
    want = runs["want"][cid]
    calls = [r["calls"] for r in runs["loaders"][cid]]
    for rank, got in enumerate(runs["loaders"][cid]):
        lo, hi = got["rows"]
        expect = []
        for epoch in (0, 1):
            order = want[epoch]["order"]
            plan = {}
            for p in (s * batch + r for s in range(got["steps"]) for r in range(lo, hi)):
                plan.setdefault(int(order[p // ns]), []).append(p % ns)
            expect += [(epoch, idx, None if len(ks) == ns else ks) for idx, ks in plan.items()]
        assert sorted(calls[rank], key=str) == sorted(expect, key=str), rank
        assert len({idx for e, idx, _ in calls[rank] if e == 0}) < VOLUMES
    if (batch // nd) % ns:  # a straddled volume: two data ranks, complementary samples
        first = {idx: keep for e, idx, keep in calls[0] if e == 0}
        other = {idx: keep for e, idx, keep in calls[ns_space] if e == 0}
        shared = first.keys() & other.keys()
        assert shared and all(sorted(first[i] + other[i]) == list(range(ns)) for i in shared)


@pytest.mark.parametrize("cid", list(DRIVER_CASES))
def test_driver_rank_view_equals_the_global_view(runs, cid):
    world = DRIVER_CASES[cid][0]
    results = runs["loaders"][f"drivers {world}"]
    steps = None
    for r in results:
        mine, glob = r[f"{cid} rank"], r[f"{cid} global"]
        steps = len(mine["inputs"])
        assert steps == len(glob["inputs"]) > 0 and mine["step"] == glob["step"]
        for (a, b), (ga, gb) in zip(mine["inputs"], glob["inputs"]):
            np.testing.assert_array_equal(a, ga)
            np.testing.assert_array_equal(b, gb)
        for name, sd in glob["params"].items():
            for key, v in sd.items():
                assert np.array_equal(mine["params"][name][key].numpy(), v.numpy()), \
                    f"{name} {key}"
    if "--dump_patches" in DRIVER_CASES[cid][1]:
        dumps = {view: runs["ck"] / f"{cid}_{view}" / "patch_dumps" for view in ("rank", "global")}
        names = sorted(p.name for p in dumps["rank"].iterdir())
        assert names == [f"patch_{i:04d}_{t}.nii.gz" for i in range(3) for t in "AB"]
        assert names == sorted(p.name for p in dumps["global"].iterdir())
        for name in names:  # gzip headers carry the write time; the NIfTI bytes
            assert gzip.decompress((dumps["rank"] / name).read_bytes()) == \
                gzip.decompress((dumps["global"] / name).read_bytes()), name


@pytest.mark.parametrize("workers", [0, 4])
def test_rank_view_refuses_a_volume_short_of_num_samples(workers):
    """Rows map to (volume, sample) through num_samples pairs a volume: a
    volume that gives fewer raises in the consumer instead of shifting the
    rows after it; the global view takes it as the JAX loader does."""
    from mra_gan_tpu_torch.data.dataset import PatchLoader

    class Short:
        seed, num_samples = 0, 2

        def __len__(self):
            return 3

        def sample_patches(self, idx, epoch=0, keep=None):
            x = np.full((2, 2, 2, 1), float(idx), np.float32)
            pairs = [(x, x)] * (1 if idx == 1 else 2)
            return pairs if keep is None else [pairs[k] for k in keep if k < len(pairs)]

    assert len(list(PatchLoader(Short(), batch_size=2, shuffle=False,
                                workers=workers).epoch(0))) == 2
    with pytest.raises(ValueError, match="volume 1 gave 0 samples, not 1"):
        list(PatchLoader(Short(), batch_size=2, shuffle=False, workers=workers,
                         rows=(1, 2)).epoch(0))
