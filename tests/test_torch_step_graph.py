"""The train step's CUDA graph (``steps.make_train_step``).

On the CPU, through a stand-in for ``steps.CudaGraph`` that runs the
captured closure where a graph would record it and runs it again against
the static inputs on every replay: graph steps give the eager step's
losses, gradients and parameters bit for bit (U-GAT-IT's spectral-norm
``u`` buffers too, which each replay's power iterations move), each step
returns its own metrics, each step counts one step's kernel launches and paths (the
capturing one too), ``graph_capture`` and ``graph_replay`` land on the
right roots, the step stays eager on the CPU device, on a mesh, with
dropout, ``remat`` and ``paired``, a second input shape captures its own
graph, and moved parameters are captured again.

On the card (marked ``card``; skips without CUDA): five graph steps of
the U-Net and ResNet recipes at batch 8 and 256² against five eager steps
from the same weights, batches and jitter seed, their launches, and the
counted syncs against torch's sync debug mode on the capturing and a
replayed step. This file imports no JAX; on a machine without JAX run it
without the test folder's conftest:

    python3 -m pytest --noconftest tests/test_torch_step_graph.py -m card -s
"""

import warnings

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import kernels, steps, tracing
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.augment import random_jitter_batch
from cyclegan_tpu_torch.ops import cuda_conv, cuda_norm_act
from tests.test_torch_ugatit import CFG as UGATIT_CFG
from tests.test_torch_ugatit import WEIGHTS as UGATIT_WEIGHTS
from tests.test_torch_ugatit import _images as ugatit_images

SIZE, BATCH, STEPS = 32, 2, 5
WEIGHTS = dict(cycle=2.0, identity=0.5, generator=1.0, discriminator=0.5)
ADAM = dict(name="adam", learning_rate=2e-4, beta_1=0.5)
EAGER_SPANS = {"jitter", "optimizer", "forward", "backward"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.reset()
    yield
    tracing.reset()


def _leaves(tree) -> list:
    """The tensors of nested tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _leaves(item)]
    return []


class StandIn:
    """A CUDA graph on the CPU. ``capture`` runs the closure, a run that
    stands for the replay the step makes at once on the same static
    inputs (a graph only records it, and a second run would move state
    the closure writes in place, a spectral norm's ``u``, twice); every
    later ``replay`` runs it again against the static inputs, with the
    kernel counters left as they were (a replay calls no wrapper), and
    copies each tensor it returns into the captured ones, where a graph
    rewrites its outputs in place."""

    made = []

    @staticmethod
    def usable(device) -> bool:
        return True

    def __init__(self):
        StandIn.made.append(self)

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        self.ran = True
        return self.out

    def replay(self) -> None:
        if self.ran:  # the capture's run was this replay's
            self.ran = False
            return
        launches, paths = dict(kernels.launches), kernels.paths.copy()
        fresh = self.fn()
        kernels.launches.update(launches)
        kernels.paths.clear()
        kernels.paths.update(paths)
        for held, new in zip(_leaves(self.out), _leaves(fresh), strict=True):
            held.copy_(new)


@pytest.fixture
def stand_in(monkeypatch):
    StandIn.made = []
    monkeypatch.setattr(steps, "CudaGraph", StandIn)
    return StandIn


def _config(normalization="instancenorm", dropout=False):
    unet = dict(type="unet_generator", filters=[4, 4], kernels=[3, 3],
                expansion="upsample", normalization=normalization,
                dropout=dropout)
    return dict(generator=dict(unet, output_channels=3,
                               final_activation="tanh"),
                discriminator=dict(unet, output_channels=1,
                                   final_activation="sigmoid"))


def _state(seed=0, model=None, **config):
    return steps.init_train_state(
        steps.build_models(model or _config(**config), seed),
        dict(g_opt=ADAM, d_opt=ADAM), seed, "cpu")


def _jitter(generator, a, b, rows=None):
    return (random_jitter_batch(generator, a, SIZE, rows),
            random_jitter_batch(generator, b, SIZE, rows))


def _batches(n=STEPS, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.integers(
        0, 256, (batch, SIZE + 6, SIZE + 6, 3), dtype=np.uint8))
        for _ in range(2)) for _ in range(n)]


def _run(state, step, batches):
    """Each step's returned metrics, in order."""
    return [step(state, a, b) for a, b in batches]


def _snapshot(state):
    return ({f"{n}.{k}": p.detach().clone() for n, m in state.models.items()
             for k, p in m.named_parameters()},
            {f"{n}.{k}": p.grad.clone() for n, m in state.models.items()
             for k, p in m.named_parameters()},
            {f"{n}.{k}": b.clone() for n, m in state.models.items()
             for k, b in m.named_buffers()})


def _roots():
    return [e for e in tracing.entries() if e["name"] == "train_step"]


def _graph_counters(entry):
    return {k: v for k, v in entry["counters"].items()
            if k.startswith("graph_")}


@pytest.mark.parametrize("options,config", [
    (dict(), dict()),
    (dict(tpu_layout=False), dict()),
    (dict(fuse_apps=True), dict()),
    (dict(), dict(normalization="batchnorm")),
    (dict(), "ugatit"),
], ids=["nhcw", "nhwc", "fuse_apps", "batchnorm", "ugatit"])
def test_graph_steps_are_the_eager_steps(monkeypatch, options, config):
    """Five steps through the stand-in against five eager steps from the
    same weights, batches and jitter seed (U-GAT-IT: three steps, eager,
    capturing and replayed, of ``test_torch_ugatit.py``'s tiny model on
    its images): every step's metrics (read after all of them, so none was
    overwritten by a later replay), and the parameters, gradients and
    buffers (batch-norm statistics, spectral-norm ``u``) after the last,
    bit-equal."""
    loss, weights, preprocess, batches = "mse", WEIGHTS, _jitter, _batches()
    if config == "ugatit":
        loss, weights, preprocess = "ugatit", UGATIT_WEIGHTS, None
        batches = [(ugatit_images(2 * i), ugatit_images(2 * i + 1))
                   for i in range(3)]
        config = dict(model=UGATIT_CFG)
    eager_state = _state(**config)
    eager = _run(eager_state, steps.make_train_step(
        loss, weights, preprocess=preprocess, **options), batches)
    assert not any(_graph_counters(e) for e in _roots())

    StandIn.made = []
    monkeypatch.setattr(steps, "CudaGraph", StandIn)
    graph_state = _state(**config)
    graphed = _run(graph_state, steps.make_train_step(
        loss, weights, preprocess=preprocess, **options), batches)
    assert len(StandIn.made) == 1
    for i, (want, got) in enumerate(zip(eager, graphed)):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    ids = [id(v) for m in graphed for v in m.values()]
    assert len(set(ids)) == len(ids)  # each step's metrics its own
    for want, got in zip(_snapshot(eager_state), _snapshot(graph_state)):
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert graph_state.step == eager_state.step == len(batches)


def _counting_dispatchers(monkeypatch):
    """K1 and K2's dispatchers at their plain versions, each call counted
    in ``kernels.launches`` and under a path in ``kernels.paths``, as the
    card's wrappers count."""
    for module, name, key in ((cuda_conv, "_conv_same", "conv_same"),
                              (cuda_norm_act, "_instance_norm_act",
                               "instance_norm_act")):
        def counted(*args, _plain=getattr(module, name), _key=key,
                    **kwargs):
            kernels.launches[_key] += 1
            kernels.paths[f"{_key}.test"] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


def test_each_step_counts_one_steps_launches(monkeypatch, stand_in):
    """Eager, capturing and replayed steps each add one step's launches
    and paths, and the root's ``launches`` is that change."""
    _counting_dispatchers(monkeypatch)
    state = _state()
    step = steps.make_train_step("mse", WEIGHTS, preprocess=_jitter)
    changes = []
    for a, b in _batches():
        launched, paths = kernels.launched(), kernels.paths.copy()
        step(state, a, b)
        changes.append((kernels.launched() - launched,
                        dict(kernels.paths - paths)))
    roots = _roots()
    assert [e["launches"] for e in roots] == [n for n, _ in changes]
    assert changes[0][0] > 0 and changes[0][1]
    assert all(change == changes[0] for change in changes)


def test_capture_and_replay_land_on_their_roots(stand_in):
    """The first step eager, the second ``graph_capture`` with span
    ``capture`` (zero_grad, forward and backward under it), the rest
    ``graph_replay`` with span ``replay``; a replayed step has no
    ``forward`` or ``backward`` span of its own."""
    state = _state()
    _run(state, steps.make_train_step("mse", WEIGHTS, preprocess=_jitter),
         _batches())
    roots = _roots()
    top = [{s for s in e["spans"] if "/" not in s} for e in roots]
    assert [_graph_counters(e) for e in roots] == [
        {}, {"graph_capture": 1}] + [{"graph_replay": 1}] * (STEPS - 2)
    assert top[0] == EAGER_SPANS
    assert top[1] == {"jitter", "capture", "optimizer"}
    assert {"capture/optimizer", "capture/forward",
            "capture/backward"} <= set(roots[1]["spans"])
    assert all(t == {"jitter", "replay", "optimizer"} for t in top[2:])


def test_a_second_shape_captures_its_own_graph(stand_in):
    """Batch 2 three times, batch 4 three times, batch 2 again: each shape
    eager, captured, replayed, and the first graph replayed after the
    second."""
    state = _state()
    step = steps.make_train_step("mse", WEIGHTS, preprocess=_jitter)
    small, large = _batches(4, 2), _batches(3, 4, seed=1)
    _run(state, step, small[:3] + large + small[3:])
    seen = [_graph_counters(e) for e in _roots()]
    cycle = [{}, {"graph_capture": 1}, {"graph_replay": 1}]
    assert seen == cycle + cycle + [{"graph_replay": 1}]
    assert len(stand_in.made) == 2


def test_moved_parameters_capture_again(stand_in):
    """A parameter given new memory after the capture makes the next step
    capture again; ``load_state_dict`` copies in place and the graph
    keeps replaying; a ``.grad`` set to None in between is the graph's
    gradient again after the next replay."""
    state = _state()
    step = steps.make_train_step("mse", WEIGHTS, preprocess=_jitter)
    batches = _batches(6)
    _run(state, step, batches[:3])
    params = [p for n in steps.NETWORKS
              for p in state.models[n].parameters()]
    written = [p.grad for p in params]  # the buffers the graph writes
    model = state.models["g_AB"]
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()})
    for opt in state.optimizers.values():
        opt.zero_grad(set_to_none=True)
    step(state, *batches[3])
    assert all(g is not None and p.grad is g
               for p, g in zip(params, written))
    first = next(model.parameters())
    with torch.no_grad():
        first.data = first.data.clone()
    _run(state, step, batches[4:])
    seen = [_graph_counters(e) for e in _roots()]
    assert seen[3:] == [{"graph_replay": 1}, {"graph_capture": 1},
                        {"graph_replay": 1}]
    assert len(stand_in.made) == 2


def _mesh_of_one(tmp_path):
    import torch.distributed as dist

    from cyclegan_tpu_torch.parallel import create_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    return create_mesh(1)


@pytest.mark.parametrize("case", ["cpu", "mesh", "dropout", "remat",
                                  "paired"])
def test_eager_where_a_graph_would_not_hold(monkeypatch, tmp_path, case):
    """Three steps each: the CPU device (the real ``CudaGraph``), and with
    the stand-in a mesh, generators with dropout, ``remat`` and
    ``paired``: no capture, no ``graph_`` counter, the eager spans."""
    import torch.distributed as dist

    StandIn.made = []
    if case != "cpu":
        monkeypatch.setattr(steps, "CudaGraph", StandIn)
    options = {"remat": dict(remat=True), "paired": dict(paired=True)}.get(
        case, {})
    if case == "mesh":
        options = dict(mesh=_mesh_of_one(tmp_path))
    state = _state(dropout=case == "dropout")
    try:
        _run(state, steps.make_train_step("mse", WEIGHTS, preprocess=_jitter,
                                          **options), _batches(3))
    finally:
        if case == "mesh":
            dist.destroy_process_group()
    roots = _roots()
    assert len(roots) == 3 and not StandIn.made
    for e in roots:
        assert not _graph_counters(e)
        assert {s for s in e["spans"] if "/" not in s} == EAGER_SPANS


# -- on the card ----------------------------------------------------------

RECIPES = {"unet": "configs/cycle.yaml", "resnet": "configs/resnet.yaml"}
CARD_BATCH, CARD_SIZE = 8, 256


_REAL_GRAPH = steps.CudaGraph


class Eager:
    """``steps.CudaGraph`` refusing every device: the eager step."""

    @staticmethod
    def usable(device) -> bool:
        return False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def _card_run(recipe, graph: bool, monkeypatch, folder):
    """Five bf16 steps of ``recipe`` from seed 0's weights on seeded
    batches, with the jitter seeded: (each step's losses, the parameters
    after them, the roots of the steps, the kernel launches counted in
    each step, torch's sync warnings and the counted syncs of steps 2 and
    3)."""
    from cyclegan_tpu_torch.trainer import CycleGan

    monkeypatch.setattr(steps, "CudaGraph",
                        _REAL_GRAPH if graph else Eager)
    model = yaml2namespace(RECIPES[recipe])
    model.location = str(folder)
    train = yaml2namespace("configs/training_config.yaml")
    train.update(batch_size=CARD_BATCH, image_size=CARD_SIZE,
                 compute_dtype="bfloat16", tpu_layout=True)
    gan = CycleGan(model, train, device="cuda")
    gan.state.generator.manual_seed(7)
    rng = np.random.default_rng(3)
    batches = [tuple(rng.integers(0, 256, (CARD_BATCH, CARD_SIZE + 30,
                                            CARD_SIZE + 30, 3),
                                  dtype=np.uint8) for _ in range(2))
               for _ in range(STEPS)]
    tracing.reset()
    losses, launched, synced = [], [], []
    for i, (a, b) in enumerate(batches):
        before = kernels.launched()
        if i in (1, 2):
            metrics, warned = _synced(
                lambda: gan.train_step_fn(gan.state, *gan._put(a, b)))
            put, root = tracing.entries()[-2:]
            synced.append((warned, put["counters"].get("sync", 0)
                           + root["counters"].get("sync", 0)))
        else:
            metrics = gan.train_step_fn(gan.state, *gan._put(a, b))
        launched.append(kernels.launched() - before)
        losses.append({k: v.float().cpu() for k, v in metrics.items()})
    params = {f"{n}.{k}": p.detach().float().cpu()
              for n, m in gan.state.models.items()
              for k, p in m.named_parameters()}
    roots = _roots()
    del gan
    torch.cuda.empty_cache()
    return losses, params, roots, launched, synced


def _synced(work):
    """(what ``work`` returns, the synchronizing CUDA operations torch's
    sync debug mode warned of while it ran)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = work()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def _gap(x, y) -> float:
    return float((x - y).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_graph_steps_on_the_card(card, monkeypatch, tmp_path, recipe):
    """Two eager runs and one graph run of five steps: where the eager
    runs agree bit for bit the graph run does too; elsewhere (cuDNN's
    stride-2 and transposed convs are not deterministic) it is no farther
    from the first eager run than twice the eager runs' own distance.
    Each step launches the eager step's kernels, and the counted syncs
    equal torch's warnings on the capturing and a replayed step."""
    eager1, eager2, graph = (_card_run(recipe, graph, monkeypatch,
                                       tmp_path / str(i))
                             for i, graph in enumerate((False, False, True)))
    counters = [_graph_counters(e) for e in graph[2]]
    assert counters == [{}, {"graph_capture": 1}] + [
        {"graph_replay": 1}] * (STEPS - 2)
    assert not any(_graph_counters(e) for e in eager1[2])

    pairs = [(f"loss{i}.{k}", e1[k], e2[k], g[k]) for i, (e1, e2, g) in
             enumerate(zip(eager1[0], eager2[0], graph[0])) for k in e1]
    pairs += [(k, eager1[1][k], eager2[1][k], graph[1][k])
              for k in eager1[1]]
    loose = []
    for name, e1, e2, g in pairs:
        if torch.equal(e1, e2):
            assert torch.equal(g, e1), name
        else:
            loose.append(name)
            assert _gap(g, e1) <= 2 * _gap(e2, e1), (
                name, _gap(g, e1), _gap(e2, e1))
    print(f"{recipe}: {len(pairs) - len(loose)} of {len(pairs)} bit-equal "
          f"between eager runs and the graph run; the rest within twice "
          f"the eager distance")

    assert graph[3] == eager1[3] and len(set(graph[3])) == 1
    assert [e["launches"] for e in graph[2]] == graph[3]
    print(f"{recipe}: launches a step {graph[3][0]}; syncs (torch, "
          f"counted) capturing {graph[4][0]}, replayed {graph[4][1]}")
    for warned, counted in graph[4] + eager1[4]:
        assert warned == counted
    assert graph[4][0][1] == graph[4][1][1] + 1  # the capture's one wait
