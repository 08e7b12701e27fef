"""The training step's CUDA graph, on the CPU: which configurations it
admits, the forward's constants built once (no host copy after the first
call), the noise drawn ahead of the step as the forward draws it, and the
returned losses left as they are by a later call. Capture and replay
themselves run on the card (``chip_smoke.py``'s graph phase)."""

import collections
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from unsupervised_pose_estimation_tpu_torch.ops import geometry as G
from unsupervised_pose_estimation_tpu_torch.ops import resize as R
from unsupervised_pose_estimation_tpu_torch.parallel.mesh import Mesh
from unsupervised_pose_estimation_tpu_torch.train import step as tstep
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.state import \
    create_train_state

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.traffic.train_loop import options  # noqa: E402

B, H, W = 2, 32, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port, so that pytest's parallel workers
    do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bench_options(name, **overrides):
    """The options of a benchmark configuration (``benchmark/configs``)."""
    return options(json.loads((ROOT / "benchmark" / "configs" /
                               f"{name}.json").read_text()), overrides)


def small_batch(seed=0, frames=3):
    rng = np.random.default_rng(seed)
    return {"color": torch.from_numpy(rng.integers(
                0, 256, (B, frames, H, W, 3), dtype=np.uint8)),
            "K_norm": torch.tensor([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                                    [0, 0, 1, 0], [0, 0, 0, 1]]).expand(
                B, 4, 4).contiguous(),
            "aug_params": torch.tensor([[1.0, 1.1, 0.9, 1.15, 0.05, 1.0],
                                        [1.0, 0.9, 1.1, 0.85, -0.04, 0.0]])}


class HostReads(TorchDispatchMode):
    """Counts the operators that build a tensor from host data (what a
    copy to the card starts from: ``torch.tensor``, ``new_tensor``, a
    number set into a tensor) or read one back (``item``, ``bool``,
    ``float``); ``tolist`` is counted by ``watch_tolist``."""

    NAMES = ("aten.lift_fresh", "aten._local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.NAMES):
            self.seen[name] += 1
        return func(*args, **(kwargs or {}))


def watch_tolist(monkeypatch, seen):
    tolist = torch.Tensor.tolist

    def counted(self):
        seen["tolist"] += 1
        return tolist(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)


@pytest.mark.parametrize("name,device,change,admitted", [
    ("monodepth2_m640x192", "cuda", {}, True),
    ("fork_m640x192_f32", "cuda:0", {}, True),
    ("monodepth2_m640x192", "cpu", {}, False),
    ("monodepth2_m640x192", "cuda", {"mesh": Mesh(1, 2, 1)}, False),
    ("monodepth2_m640x192", "cuda", {"pallas_warp_version": 7}, False),
    ("monodepth2_m640x192", "cuda", {"v1_multiscale": True}, False),
])
def test_the_graph_admits_the_benchmark_configurations(name, device, change,
                                                       admitted):
    """Decided on what the step sees: the device, the mesh, the shards and
    the configuration (never its name)."""
    change = dict(change)
    mesh = change.pop("mesh", None)
    cfg = bench_options(name, **change)
    assert tstep.graph_capturable(cfg, torch.device(device), mesh,
                                  None) is admitted


def old_project(points, K, T, height, width, eps=1e-7):
    P = (K @ T)[:, :3, :]
    cam = P[:, :, :3] @ points + P[:, :, 3:4]
    xy = cam[:, :2] / (cam[:, 2:3] + eps)
    scale = torch.tensor([width - 1, height - 1], dtype=points.dtype,
                         device=points.device)
    pix = xy.reshape(points.shape[0], 2, height, width)
    return (pix / scale[:, None, None] - 0.5) * 2.0


def old_scaled_intrinsics(K_norm, width, height, scale):
    mult = torch.ones(4, dtype=K_norm.dtype, device=K_norm.device)
    mult[0] = width // (2 ** scale)
    mult[1] = height // (2 ** scale)
    return K_norm * mult[None, :, None]


def old_resize(x, height, width, method):
    _, h, w, _ = x.shape
    if h != height:
        x = torch.einsum("bhwc,hH->bHwc", x, torch.tensor(
            R._weights(h, height, method), device=x.device))
    if w != width:
        x = torch.einsum("bhwc,wW->bhWc", x, torch.tensor(
            R._weights(w, width, method), device=x.device))
    return x


def old_pyramid(x, n):
    pyr = [x]
    for _ in range(1, n):
        _, h, w, _ = pyr[-1].shape
        pyr.append(old_resize(pyr[-1], h // 2, w // 2, "lanczos3"))
    return pyr


def case_inputs():
    gen = torch.Generator().manual_seed(5)
    return {"K_norm": small_batch()["K_norm"],
            "depth": torch.rand((B, H >> 1, W >> 1, 1), generator=gen) * 10
            + 0.5,
            "T": G.transformation_from_parameters(
                torch.randn((B, 3), generator=gen) * 0.05,
                torch.randn((B, 3), generator=gen) * 0.1),
            "disp": torch.rand((B, H >> 2, W >> 2, 1), generator=gen),
            "image": torch.rand((B, H, W, 3), generator=gen)}


def geometry(x, scaled_intrinsics, project):
    K = scaled_intrinsics(x["K_norm"], W, H, 1)
    points = G.backproject(x["depth"], G.invert_intrinsics(K))
    return [K, project(points, K, x["T"], H >> 1, W >> 1)]


# (the function as it is, the old one)
CASES = {
    "project": (lambda x: geometry(x, G.scaled_intrinsics, G.project),
                lambda x: geometry(x, old_scaled_intrinsics, old_project)),
    "resize_bilinear": (lambda x: [R.resize_bilinear(x["disp"], H, W)],
                        lambda x: [old_resize(x["disp"], H, W, "bilinear")]),
    "image_pyramid": (lambda x: R.image_pyramid(x["image"], 4),
                      lambda x: old_pyramid(x["image"], 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_constants_are_the_old_bits_and_built_once(case):
    """``project`` and ``scaled_intrinsics`` (geometry), ``resize_bilinear``
    and ``image_pyramid`` give the bits of the code that built their
    constants from host numbers at every call; their second call builds
    nothing from the host and reuses the first call's tensors."""
    x = case_inputs()
    G.constant.cache_clear()
    R._weights_on.cache_clear()
    now, before = CASES[case]
    first, old = now(x), before(x)
    assert len(first) == len(old)
    for a, b in zip(first, old):
        assert torch.equal(a, b)
    with HostReads() as reads:
        second = now(x)
    assert not reads.seen
    assert G.constant.cache_info().hits + R._weights_on.cache_info().hits
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["monodepth2_m640x192",
                                  "fork_m640x192_f32"])
def test_the_forward_reads_nothing_back_after_its_first_call(name,
                                                             monkeypatch):
    """The forward and backward of both benchmark configurations build no
    tensor from host data and read none back once they have run, so that a
    CUDA stream can be captured through them (on the CPU the kernels run
    their plain twins; the card's wrappers read no tensor either)."""
    cfg = bench_options(name, height=H, width=W, batch_size=B)
    bundle = ModelBundle.create(cfg, device="cpu")
    batch = small_batch()
    gen = torch.Generator().manual_seed(0)
    tstep.forward_and_loss(bundle, batch, train=True, generator=gen)
    seen = collections.Counter()
    watch_tolist(monkeypatch, seen)
    with HostReads() as reads:
        total, _ = tstep.forward_and_loss(bundle, batch, train=True,
                                          generator=gen)
        total.backward()
    seen.update(reads.seen)
    assert not seen


@pytest.mark.parametrize("change", [{}, {"grad_accum": 2},
                                    {"avg_reprojection": True}])
def test_noise_drawn_ahead_is_the_forwards_own(change):
    """The noise ``draw_noise`` takes from ``noise_generator(seed, step)``,
    scale by scale and microbatch by microbatch, passed to the step, gives
    the bits of the step that draws it inside its forward: the losses and
    every parameter after the update."""
    cfg = bench_options("monodepth2_m640x192", height=H, width=W,
                        batch_size=B, compute_dtype="float32", **change)
    batch = small_batch(1)
    runs = []
    for ahead in (False, True):
        bundle = ModelBundle.create(cfg, device="cpu")
        state = create_train_state(bundle)
        noise = (tstep.draw_noise(cfg, B, tstep.noise_generator(
            cfg.seed, state.step, "cpu"), "cpu") if ahead else None)
        losses = tstep.build_train_step(bundle)(state, batch, noise=noise)
        runs.append((losses, [p.detach().clone()
                              for p in bundle.main_parameters()]))
    (inside, p_inside), (drawn, p_drawn) = runs
    assert sorted(inside) == sorted(drawn)
    for k in inside:
        assert torch.equal(inside[k], drawn[k]), k
    for a, b in zip(p_inside, p_drawn):
        assert torch.equal(a, b)


def test_returned_losses_stay_after_a_later_call():
    """A loss dict a caller holds is the call's own: the next call writes
    none of its tensors."""
    cfg = bench_options("monodepth2_m640x192", height=H, width=W,
                        batch_size=B, compute_dtype="float32")
    bundle = ModelBundle.create(cfg, device="cpu")
    state = create_train_state(bundle)
    step = tstep.build_train_step(bundle)
    held = step(state, small_batch(2))
    kept = {k: v.clone() for k, v in held.items()}
    later = step(state, small_batch(3))
    assert state.step == 2
    assert any(not torch.equal(later[k], kept[k]) for k in kept)
    for k in kept:
        assert torch.equal(held[k], kept[k]), k


def test_a_replay_counts_what_its_capture_took_back():
    """A graph's capture records its launches and ladder rungs without
    running them, so ``_StepGraph`` takes them back (``add_counts`` at -1)
    and adds them at each replay: a capture and its replays count as many
    steps as the replays."""
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K

    launches = {"warp_reproj_loss": 8, "warp_reproj_loss_bwd": 8,
                "reproj_loss": 2}
    rungs = {"v8": 16}
    K.reset_counts()
    try:
        K.add_counts(launches, rungs)          # what the capture counted
        K.add_counts(launches, rungs, -1)      # taken back
        for _ in range(3):
            K.add_counts(launches, rungs)      # the replays
        assert {k: n for k, n in K.counts().items() if n} == {
            k: 3 * n for k, n in launches.items()}
        assert {k: n for k, n in K.rung_counts().items() if n} == {"v8": 48}
    finally:
        K.reset_counts()


@pytest.mark.parametrize("device,world,capturable", [
    ("cpu", None, False), ("cuda", None, True), ("cuda:0", 1, True),
    ("cuda", 2, False)])
def test_adam_is_capturable_on_one_cuda_process(monkeypatch, device, world,
                                                capturable):
    """The main Adam's mode is fixed where it is made, from the device and
    the processes: ``capturable`` on one CUDA device of one process."""
    from unsupervised_pose_estimation_tpu_torch.train import state as tstate

    if world is not None:
        monkeypatch.setattr(tstate.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(tstate.dist, "get_world_size", lambda: world)
    assert tstate.adam_capturable(torch.device(device)) is capturable
    if device == "cpu":
        cfg = bench_options("monodepth2_m640x192", height=H, width=W,
                            batch_size=B)
        state = create_train_state(ModelBundle.create(cfg, device="cpu"))
        assert not tstate.is_capturable(state.optimizer)


def test_the_graphs_control_flow_counts_as_eager_calls(monkeypatch):
    """``_StepGraph``'s control flow on the CPU, with ``torch.cuda``'s
    graph and streams faked (a capture runs the step as it records it, a
    replay runs nothing) and capturable Adam let onto the CPU: two eager
    calls, a capture, replays; each call counts the same launches, a
    replay those its capture took back; Adam keeps its mode through a
    save in eager form and a load, which starts the warm-up again."""
    import contextlib

    import torch.optim.adam as adam_module
    import torch.optim.optimizer as optimizer_module

    from unsupervised_pose_estimation_tpu_torch import tracing
    from unsupervised_pose_estimation_tpu_torch.ops import kernels as K
    from unsupervised_pose_estimation_tpu_torch.ops.kernels import _lib
    from unsupervised_pose_estimation_tpu_torch.train import state as tstate

    class Graph:
        def replay(self):
            pass

    class Stream:
        def __init__(self, device=None):
            self.device = device

        def wait_stream(self, other):
            pass

    devices = lambda supports_xla=True: ["cuda", "cpu"]  # noqa: E731
    for module in (adam_module, optimizer_module):
        monkeypatch.setattr(module, "_get_capturable_supported_devices",
                            devices)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream(device))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(tstep, "graph_capturable", lambda *a, **k: True)
    monkeypatch.setattr(tstate, "adam_capturable", lambda device: True)
    op = tstep.warp_reproj_loss_op

    def launched(*args, **kwargs):
        with _lib._lock:
            _lib.LAUNCHES["warp_reproj_loss"] += 1
        return op(*args, **kwargs)

    monkeypatch.setattr(tstep, "warp_reproj_loss_op", launched)
    cfg = bench_options("monodepth2_m640x192", height=H, width=W,
                        batch_size=B, compute_dtype="float32")
    bundle = ModelBundle.create(cfg, device="cpu")
    state = tstate.create_train_state(bundle)
    assert tstate.is_capturable(state.optimizer)
    step = tstep.build_train_step(bundle)

    def graph_counts():
        return {k: tracing.counters().get(f"step.{k}", 0)
                for k in ("eager", "graph_captures", "graph_replays")}

    def calls(n):
        before = graph_counts()
        for _ in range(n):
            K.reset_counts()
            step(state, small_batch(state.step))
            assert K.counts()["warp_reproj_loss"] == 8   # 4 scales x 2
        return {k: v - before[k] for k, v in graph_counts().items()}

    try:
        assert calls(4) == {"eager": 2, "graph_captures": 1,
                            "graph_replays": 2}
        saved = tstate.optimizer_state_dict(state)
        group = saved["param_groups"][0]
        assert group["capturable"] is False and isinstance(group["lr"], float)
        tstate.load_optimizer_state_dict(state, saved)
        assert tstate.is_capturable(state.optimizer)
        assert calls(3) == {"eager": 2, "graph_captures": 1,
                            "graph_replays": 1}
        assert state.step == 7
    finally:
        K.reset_counts()
