"""The sliding-window decode's CUDA-graph replays
(mra_gan_tpu_torch/infer/sliding_window.py ``_Graphed``) on the CPU.

A card records the generator's forward once a patch batch shape and replays
it. Here ``_capture`` is replaced by a recorder whose replay runs the network
again, so the bookkeeping is checked against the eager decode's bits: the
first batch of a shape eager, one recording a shape, each run counted once in
the wrappers' counters (the recording's counts taken back), the graphs kept
from one decode to the next and dropped on a new route."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mra_gan_tpu_torch.infer import sliding_window as sw
from mra_gan_tpu_torch.models.cycle_gan import CycleGANConfig, GenerateFn, make_generate_fn
from mra_gan_tpu_torch.ops.kernels import conv7 as C7
from mra_gan_tpu_torch.ops.kernels import instance_norm as K
from mra_gan_tpu_torch.ops.kernels import replication_pad as RP
from mra_gan_tpu_torch.utils.profiling import plain_norms

# 36 x 20 x 18 at 16^3 patches, stride 8: 4 x 2 x 2 = 16 patches
VOLUME, PATCH, STRIDE = (36, 20, 18), (16, 16, 16), 8
N_PATCHES = 16


class CountingGenerate(GenerateFn):
    """A GenerateFn that counts a call as the card's wrappers count the
    launches of a forward: one slab norm, two pads, one conv7 spread."""

    def __call__(self, x):
        K.LAUNCHES["instance_norm_slab"] += 1
        RP.LAUNCHES["replication_pad_fwd"] += 2
        C7.LAUNCHES["conv7_spread"] += 1
        return super().__call__(x)


class FakeGraph:
    """A recording: its replay runs the network on the recorded input into
    the recorded output, past the counting call."""

    def __init__(self, fn, x, y):
        self.fn, self.x, self.y, self.replays = fn, x, y, 0

    def replay(self):
        self.replays += 1
        with torch.inference_mode():
            self.y.copy_(self.fn.net(self.x.to(self.fn.dtype)))


@pytest.fixture
def graphs(monkeypatch):
    recorded = []

    def capture(fn, x, pool):
        y = fn(x)  # counted like a recording on the card, and taken back
        recorded.append(FakeGraph(fn, x, y))
        return recorded[-1], y, pool if pool is not None else object()

    monkeypatch.setattr(sw, "_capture", capture)
    monkeypatch.setattr(sw, "_graphs_apply", lambda fn, dev: isinstance(fn, GenerateFn))
    return recorded


@pytest.fixture
def gen():
    made = make_generate_fn(CycleGANConfig(ngf=4, dtype=torch.float32), "g_a", device="cpu",
                            seed=3)
    return CountingGenerate(made.net, made.dtype, made.device)


def _volume(seed=5):
    return np.random.RandomState(seed).uniform(-1, 1, VOLUME).astype(np.float32)


def _decode(gen, vol, batch, graphs=True):
    return sw.sliding_window_inference(vol, gen, PATCH, STRIDE, STRIDE, "gaussian", batch,
                                       graphs=graphs)


def _reset():
    K.reset_launches()
    C7.reset_launches()
    RP.reset_launches()


@pytest.mark.parametrize("batch", [5, 3, 16])
def test_replays_give_the_eager_bits_and_count_each_run_once(graphs, gen, batch):
    vol = _volume()
    # a process's first decode on the CPU can round apart from every later one
    # (eager or not), so the eager bits are read from a second decode
    _decode(gen, vol, batch, graphs=False)
    want = _decode(gen, vol, batch, graphs=False)
    n_batches = -(-N_PATCHES // batch)
    shapes = {min(batch, N_PATCHES - i) for i in range(0, N_PATCHES, batch)}
    for decode in range(3):
        _reset()
        got = _decode(gen, vol, batch)
        np.testing.assert_array_equal(got, want)
        assert K.LAUNCHES["instance_norm_slab"] == n_batches
        assert RP.LAUNCHES["replication_pad_fwd"] == 2 * n_batches
        assert C7.LAUNCHES["conv7_spread"] == n_batches
        assert sum(v for k, v in K.LAUNCHES.items() if k != "instance_norm_slab") == 0
    # a shape's first batch runs eagerly, its second records: a shape met once
    # in a decode records in the next one, and none records twice
    assert len(graphs) == len(shapes) == len(gen._graphs["graphs"])
    assert sum(g.replays for g in graphs) == 3 * n_batches - len(shapes)
    assert {g.x.shape[0] for g in graphs} == shapes


def test_a_new_route_drops_the_graphs(graphs, gen):
    vol = _volume()
    _decode(gen, vol, 5)
    route, kept = gen._graphs["route"], gen._graphs["graphs"]
    _decode(gen, vol, 5)
    assert gen._graphs["route"] == route and gen._graphs["graphs"] is kept
    with plain_norms():
        _decode(gen, vol, 5)
        assert gen._graphs["route"] != route and gen._graphs["graphs"] is not kept
    _decode(gen, vol, 5)
    assert gen._graphs["route"] == route  # a fresh holder for the kernels' route
    with torch.no_grad():
        next(gen.net.parameters()).mul_(0.5)  # a new version: a new route
    got = _decode(gen, vol, 5)
    assert gen._graphs["route"] != route
    np.testing.assert_array_equal(got, _decode(gen, vol, 5, graphs=False))


def test_a_failed_recording_takes_its_counts_back(monkeypatch, gen):
    def capture(fn, x, pool):
        fn(x)
        raise RuntimeError("refused")

    monkeypatch.setattr(sw, "_capture", capture)
    monkeypatch.setattr(sw, "_graphs_apply", lambda fn, dev: True)
    _reset()
    with pytest.raises(RuntimeError, match="refused"):
        _decode(gen, _volume(), 5)
    # the first batch ran eagerly; the second's recording counted nothing
    assert K.LAUNCHES["instance_norm_slab"] == 1 and C7.LAUNCHES["conv7_spread"] == 1


def test_graphs_apply_only_to_a_generate_fn_on_a_card(gen):
    cuda = torch.device("cuda")
    assert not sw._graphs_apply(gen, torch.device("cpu"))
    assert not sw._graphs_apply(lambda x: x, cuda)
    with FlopCounterMode(display=False):
        assert not sw._graphs_apply(gen, cuda)


def test_the_route_follows_parameters_norms_and_determinism(gen):
    route = sw._route(gen.net)
    assert sw._route(gen.net) == route
    with plain_norms():
        assert sw._route(gen.net) != route
    saved = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = not saved
        assert sw._route(gen.net) != route
    finally:
        torch.backends.cudnn.deterministic = saved
    with torch.no_grad():
        next(gen.net.parameters()).add_(0)
    assert sw._route(gen.net) != route


def test_a_decode_runs_eagerly_while_another_holds_the_graphs(graphs, gen):
    vol = _volume()
    _decode(gen, vol, 5)
    _decode(gen, vol, 5)
    recorded = len(graphs)
    held = sw._Graphed.take(gen)  # another decode's hold
    assert held is not None and sw._Graphed.take(gen) is None
    try:
        _reset()
        got = _decode(gen, vol, 5)
        assert K.LAUNCHES["instance_norm_slab"] == 4 and len(graphs) == recorded
        assert sum(g.replays for g in graphs) == 2 * 4 - 2  # none in that decode
    finally:
        held.release()
    np.testing.assert_array_equal(got, _decode(gen, vol, 5))
    assert sum(g.replays for g in graphs) == 3 * 4 - 2
