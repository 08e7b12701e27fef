"""The port's training entry point (``cli.train.main`` -> ``Trainer``), its
checkpoints, weight imports and logs, on the CPU.

- Resume is exact: 4 uninterrupted steps equal 2 steps, a checkpoint, a
  restore and 2 more, bit for bit (losses, parameters, BatchNorm
  statistics, Adam moments, step), at 32x64, batch 4.
- The first step from the JAX Trainer's initial weights (moved with
  ``convert.from_jax``) gives the JAX Trainer's train losses within
  ``LOSS_ATOL`` (see there), and ``metrics.jsonl`` carries the same keys.
  This runs at 64x64: at 32 rows the deepest feature map has one row, where
  the JAX package's reflect pad (``ops/packed.py::_pad1_dus``) writes stray
  values instead of repeating the row (numpy's rule, which the port
  follows; tests/test_torch_models.py::test_reflect_pad_of_one_row).
- Reference-layout ``.pth`` folders (``tests/torch_oracle.py``) load into
  the same weights as the JAX importers give, mapped by ``from_jax``.

Torch runs on one thread, and the JAX Trainer (one compiled train and eval
step) is the only JAX compile here.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests import torch_oracle as oracle
from unsupervised_pose_estimation_tpu.config import Options as JOptions
from unsupervised_pose_estimation_tpu.train import checkpoint as jck
from unsupervised_pose_estimation_tpu.train.loop import Trainer as JTrainer
from unsupervised_pose_estimation_tpu_torch import convert
from unsupervised_pose_estimation_tpu_torch.cli.train import main
from unsupervised_pose_estimation_tpu_torch.config import Options
from unsupervised_pose_estimation_tpu_torch.serve import InferenceEngine
from unsupervised_pose_estimation_tpu_torch.train import checkpoint as ck
from unsupervised_pose_estimation_tpu_torch.train.bundle import ModelBundle
from unsupervised_pose_estimation_tpu_torch.train.logging import Profiler
from unsupervised_pose_estimation_tpu_torch.train.loop import Trainer

# The automask's 1e-5 tie-break noise cannot be shared between the
# packages (jax.random against torch's generator). Where the identity loss
# wins, the per-pixel minimum moves by its noise, so each loss term moves
# by at most about the mean of |noise| over those pixels (8e-6 for a
# unit normal times 1e-5), and float32 rounding adds ~1e-7 at losses of
# ~1e-2. Measured: 2.0e-7 at most.
LOSS_ATOL = 1e-5
# The noise and the loss's kinks move the gradient (a coordinate at the
# clip moved it 0.61% in tests/test_torch_train_grads.py). Measured: 4.7e-5.
GRAD_NORM_RTOL = 1e-2

SMALL = ["--dataset", "synthetic_parallax", "--height", "32", "--width",
         "64", "--batch_size", "4", "--compute_dtype", "float32",
         "--weights_init", "scratch", "--num_epochs", "1", "--num_workers",
         "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def records(log_dir, model="mdp"):
    with open(os.path.join(log_dir, model, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resume_is_bit_exact(tmp_path):
    args = SMALL + ["--steps_per_epoch", "4", "--log_frequency", "1",
                    "--ckpt_frequency", "2"]
    straight = main(args + ["--log_dir", str(tmp_path / "a")], device="cpu")
    ckpt_dir = tmp_path / "a" / "mdp" / "models" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == ["2.pt", "4.pt", "opt.json"]
    resume_dir = tmp_path / "from_step_2"
    resume_dir.mkdir()
    shutil.copy(ckpt_dir / "2.pt", resume_dir / "2.pt")

    opts = dataclasses.replace(straight.cfg, log_dir=str(tmp_path / "b"),
                               load_weights_folder=str(resume_dir))
    resumed = Trainer(opts, device="cpu")
    assert resumed.state.step == 2
    saved = torch.load(resume_dir / "2.pt", weights_only=True)
    for key, value in resumed.bundle.state_dict().items():
        assert torch.equal(value, saved["bundle"][key]), key
    resumed.train()

    def train_losses(log_dir):
        return {r["step"]: {k: v for k, v in r.items() if k != "time"}
                for r in records(log_dir) if r["mode"] == "train"}

    a, b = train_losses(tmp_path / "a"), train_losses(tmp_path / "b")
    assert sorted(a) == [0, 1, 2, 3] and sorted(b) == [2, 3]
    for step in (2, 3):
        assert a[step] == b[step], step
    assert resumed.state.step == straight.state.step == 4
    sa, sb = straight.bundle.state_dict(), resumed.bundle.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    oa = straight.state.optimizer.state_dict()["state"]
    ob = resumed.state.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][key], ob[i][key]), (i, key)


COMMON = dict(dataset="synthetic_parallax", height=64, width=64,
              batch_size=4, compute_dtype="float32", weights_init="scratch",
              num_epochs=1, steps_per_epoch=1, log_frequency=1,
              num_workers=2)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One step of the JAX Trainer: its initial weights and its records."""
    log_dir = str(tmp_path_factory.mktemp("jax_trainer"))
    trainer = JTrainer(JOptions(**COMMON, log_dir=log_dir, mesh_data=1))
    params = jax.device_get(trainer.state.params)
    stats = jax.device_get(trainer.state.batch_stats)
    trainer.train()
    return params, stats, records(log_dir)


def test_first_step_matches_the_jax_trainer(jax_run, tmp_path):
    params, stats, jax_records = jax_run
    trainer = Trainer(Options(**COMMON, log_dir=str(tmp_path)), device="cpu")
    trainer.bundle.load_state_dict(convert.from_jax(params, stats))
    trainer.train()
    ours = records(str(tmp_path))
    assert [r["mode"] for r in ours] == [r["mode"] for r in jax_records] \
        == ["train", "val"]
    for mine, ref in zip(ours, jax_records):
        assert sorted(mine) == sorted(ref), mine["mode"]
        assert mine["step"] == ref["step"] == 0
    mine, ref = ours[0], jax_records[0]
    assert mine["learning_rate"] == ref["learning_rate"]
    np.testing.assert_allclose(mine["grad_norm"], ref["grad_norm"],
                               rtol=GRAD_NORM_RTOL)
    for key in mine:
        if key.startswith(("loss", "min_loss")):
            assert abs(mine[key] - ref[key]) <= LOSS_ATOL, (key, mine[key],
                                                            ref[key])


def write_pth_folder(folder, rng, upstream_depth=False):
    """Reference-layout .pth files with seeded weights and BatchNorm
    statistics away from their init."""
    with torch.random.fork_rng():
        torch.manual_seed(int(rng.integers(1 << 31)))
        mods = {"encoder": oracle.RefResnetEncoder(1),
                "pose_encoder": oracle.RefResnetEncoder(2),
                "depth": oracle.RefDepthDecoder(),
                "pose": oracle.RefPoseDecoder()}
    os.makedirs(folder, exist_ok=True)
    for name, mod in mods.items():
        sd = mod.state_dict()
        for key, value in sd.items():
            if key.endswith("running_mean"):
                sd[key] = torch.tensor(rng.normal(0, 0.1, value.shape),
                                       dtype=torch.float32)
            elif key.endswith("running_var"):
                sd[key] = torch.tensor(rng.uniform(0.5, 1.5, value.shape),
                                       dtype=torch.float32)
        if name == "encoder":
            sd.update(height=64, width=64, use_stereo=False)
        if name == "depth" and upstream_depth:
            sd = {f"decoder.{i}.conv.conv.{p}": torch.zeros(1, 1, 3, 3)
                  for i in range(10) for p in ("weight", "bias")}
            sd.update({f"decoder.{10 + j}.conv.{p}": torch.zeros(1, 1, 3, 3)
                       for j in range(4) for p in ("weight", "bias")})
        torch.save(sd, os.path.join(folder, f"{name}.pth"))


def jax_imported_state_dict(folder):
    """The JAX importers' trees for ``folder``, through from_jax. The fork
    decoder's file has no BatchNorms, so they stay at their init."""
    enc = jck.import_resnet_encoder(os.path.join(folder, "encoder.pth"), 18)
    penc = jck.import_resnet_encoder(os.path.join(folder,
                                                  "pose_encoder.pth"), 18)
    dec = jck.import_depth_decoder(os.path.join(folder, "depth.pth"),
                                   (0, 1, 2, 3))
    pose = jck.import_pose_decoder(os.path.join(folder, "pose.pth"))
    depth_p = dict(dec["params"])
    depth_s = {}
    for i, c in enumerate((16, 32, 64, 128, 256)):
        depth_p[f"bn_{i}"] = {"scale": np.ones(c, np.float32),
                              "bias": np.zeros(c, np.float32)}
        depth_s[f"bn_{i}"] = {"mean": np.zeros(c, np.float32),
                              "var": np.ones(c, np.float32)}
    params = {"encoder": enc["params"], "pose_encoder": penc["params"],
              "depth": depth_p, "pose": pose["params"]}
    stats = {"encoder": enc["batch_stats"],
             "pose_encoder": penc["batch_stats"], "depth": depth_s}
    return convert.from_jax(params, stats)


def assert_weights_equal(ours, want):
    assert ours.keys() == want.keys()
    for key in ours:
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(ours[key], want[key]), key


def test_pth_folder_loads_what_the_jax_importers_load(tmp_path):
    folder = str(tmp_path / "pth")
    write_pth_folder(folder, np.random.default_rng(0))
    trainer = Trainer(Options(**COMMON, log_dir=str(tmp_path / "log"),
                              load_weights_folder=folder), device="cpu")
    trainer.close()
    assert_weights_equal(trainer.bundle.state_dict(),
                         jax_imported_state_dict(folder))


def test_upstream_decoder_raises_the_reference_error(tmp_path):
    folder = str(tmp_path / "pth")
    write_pth_folder(folder, np.random.default_rng(1), upstream_depth=True)
    common = dict(COMMON, load_weights_folder=folder,
                  models_to_load=("depth",))
    with pytest.raises(ValueError) as ref:
        JTrainer(JOptions(**common, log_dir=str(tmp_path / "j"),
                          mesh_data=1))
    with pytest.raises(ValueError) as ours:
        Trainer(Options(**common, log_dir=str(tmp_path / "t")),
                device="cpu")
    assert str(ours.value) == str(ref.value)
    assert "pass --depth_decoder_variant upstream" in str(ours.value)


def test_pretrained_init_matches_the_jax_import(tmp_path):
    """weights_init=pretrained: a torchvision-layout ResNet-18 file into
    both encoders, conv1 averaged over the pose encoder's two frames."""
    with torch.random.fork_rng():
        torch.manual_seed(3)
        sd = oracle.RefResnetEncoder(1).encoder.state_dict()
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 512), torch.zeros(10)
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    trainer = Trainer(Options(**dict(COMMON, weights_init="pretrained"),
                              imagenet_weights=path,
                              log_dir=str(tmp_path / "log")), device="cpu")
    trainer.close()
    for name, frames in (("encoder", 1), ("pose_encoder", 2)):
        tree = jck.import_torchvision_resnet(path, 18, frames)
        want = {}
        convert._resnet(want, name, tree["params"], tree["batch_stats"])
        ours = getattr(trainer.bundle, name).state_dict()
        for key, value in want.items():
            if not key.endswith("num_batches_tracked"):
                got = ours[key[len(name) + 1:]]
                np.testing.assert_array_equal(got.numpy(), np.asarray(value),
                                              err_msg=key)


def test_imagenet_weights_are_never_downloaded(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="--imagenet_weights"):
        ck.locate_imagenet_weights(18)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        ck.locate_imagenet_weights(18, str(tmp_path / "missing.pth"))
    hub = tmp_path / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    (hub / "resnet18-f37072fd.pth").write_bytes(b"")
    assert ck.locate_imagenet_weights(18) == str(hub / "resnet18-f37072fd.pth")


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "orbax" / "5").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax checkpoint of the JAX"):
        Trainer(Options(**COMMON, log_dir=str(tmp_path / "log"),
                        load_weights_folder=str(tmp_path / "orbax")),
                device="cpu")


def test_checkpoints_keep_the_newest(tmp_path):
    opts = Options(**COMMON)
    bundle = ModelBundle.create(opts, device="cpu")
    from unsupervised_pose_estimation_tpu_torch.train.state import \
        create_train_state

    state = create_train_state(bundle)
    for step in range(5):
        state.step = step
        ck.save_checkpoint(str(tmp_path), bundle, state, opts, keep=3)
    assert ck.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["2.pt", "3.pt", "4.pt",
                                            "opt.json"]
    assert Options.from_json((tmp_path / "opt.json").read_text()) == opts


def test_trainer_needs_a_card_unless_the_cpu_is_asked_for(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Options(**COMMON, log_dir=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="one device"):
        Trainer(Options(**COMMON, log_dir=str(tmp_path), mesh_fsdp=2),
                device="cpu")


@pytest.mark.parametrize("kind", ["checkpoint", "pth"])
def test_serving_reads_saved_weights(tmp_path, kind):
    opts = Options(**COMMON)
    folder = str(tmp_path / kind)
    by_hand = ModelBundle.create(opts, seed=11, device="cpu")
    if kind == "checkpoint":
        from unsupervised_pose_estimation_tpu_torch.train.state import \
            create_train_state

        ck.save_checkpoint(folder, by_hand, create_train_state(by_hand))
    else:
        write_pth_folder(folder, np.random.default_rng(2))
        sd = torch.load(os.path.join(folder, "encoder.pth"))
        for key in ("height", "width", "use_stereo"):
            sd.pop(key)
        by_hand.encoder.load_state_dict(sd, strict=False)
        by_hand.depth.load_state_dict(
            torch.load(os.path.join(folder, "depth.pth")), strict=False)
    images = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    engine = InferenceEngine(dataclasses.replace(
        opts, load_weights_folder=folder), max_batch=2, device="cpu")
    want = InferenceEngine(opts, max_batch=2, device="cpu",
                           bundle=by_hand).predict(images)
    got = engine.predict(images)
    np.testing.assert_array_equal(got, want)
    seeded = InferenceEngine(opts, max_batch=2, device="cpu")
    assert not np.array_equal(seeded.predict(images), got)


def test_profiler_writes_a_trace(tmp_path):
    prof = Profiler(str(tmp_path), start_step=1, num_steps=1)
    for step in range(4):
        prof.maybe_start(step)
        torch.ones(8).sum()
        prof.maybe_stop(step)
    assert os.listdir(tmp_path) == ["trace_1.json"]
