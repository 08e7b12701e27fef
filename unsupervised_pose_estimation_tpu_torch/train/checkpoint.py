"""Checkpoints with step-granular resume, and ``.pth`` imports.

Port of ``unsupervised_pose_estimation_tpu/train/checkpoint.py``. A
checkpoint is one ``torch.save`` file, ``<directory>/<step>.pt``, holding
the bundle's ``state_dict`` (parameters and BatchNorm statistics, the GAN
prior's generator and discriminator included), the Adam ``state_dict``,
with ``adversarial_prior`` the discriminator Adam's, and the step;
``opt.json`` beside it holds the options. Each file is written to a
temporary name and published with ``os.replace``, so a reader sees a whole
checkpoint or none, and the ``keep`` newest are kept.
Over a mesh of processes every rank saves and restores: under fsdp the
shards of the parameters and of the Adam moments are gathered, rank 0
writes the same file a single process writes, and every rank waits for it
at a barrier; every rank reads a checkpoint (the directory must be one
they all see) and takes its own shard. So a checkpoint of any number of
processes restores on any other number.
An orbax directory written by the reference package is refused: reading it
needs JAX.

The importers read reference-layout ``.pth`` files (the original trainer's
``encoder``, ``depth``, ``pose_encoder`` and ``pose`` files, and the
torchvision ImageNet ResNets; a ``pose`` file is a PoseCNN's under
``pose_model_type="posecnn"``, and the GAN prior's frozen CycleGAN
generator) into the port's modules, whose ``state_dict`` already uses
that layout.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import Options
from .bundle import ModelBundle
from .state import (TrainState, full_params, load_optimizer_state_dict,
                    optimizer_state_dict)

_CKPT = re.compile(r"(\d+)\.pt")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  (_CKPT.fullmatch(n) for n in os.listdir(directory)) if m)


def _is_orbax(directory: str) -> bool:
    """True for a checkpoint directory of the reference package (orbax
    keeps one numbered sub-directory per step)."""
    return os.path.isdir(directory) and any(
        name.isdigit() and os.path.isdir(os.path.join(directory, name))
        for name in os.listdir(directory))


def _refuse_orbax(directory: str):
    if _is_orbax(directory):
        raise ValueError(
            f"{directory} is an orbax checkpoint of the JAX package; reading "
            f"it needs JAX. Where JAX is installed, map its params and "
            f"batch_stats with convert.from_jax and load them into a "
            f"ModelBundle, or resume from a checkpoint of this package")


def latest_step(directory: str) -> Optional[int]:
    _refuse_orbax(directory)
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, bundle: ModelBundle, state: TrainState,
                    cfg: Optional[Options] = None, keep: int = 10) -> str:
    """Write the checkpoint of ``state.step``; -> its path. Over a mesh
    (``state.mesh``) every rank calls it, and rank 0 writes."""
    mesh = state.mesh
    path = os.path.join(directory, f"{state.step}.pt")
    with full_params(state):
        optimizer = optimizer_state_dict(state)
        if mesh is None or mesh.rank == 0:
            _write(directory, path, bundle, state, optimizer, cfg, keep)
    if mesh is not None:
        mesh.barrier(next(bundle.parameters()).device)
    return path


def _write(directory, path, bundle, state, optimizer, cfg, keep):
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    saved = {"step": state.step, "bundle": bundle.state_dict(),
             "optimizer": optimizer}
    if state.disc_optimizer is not None:
        saved["disc_optimizer"] = state.disc_optimizer.state_dict()
    torch.save(saved, tmp)
    os.replace(tmp, path)
    if cfg is not None:
        tmp = os.path.join(directory, f"opt.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(cfg.to_json())
        os.replace(tmp, os.path.join(directory, "opt.json"))
    for old in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"{old}.pt"))


def restore_checkpoint(directory: str, bundle: ModelBundle,
                       state: Optional[TrainState] = None,
                       step: Optional[int] = None) -> Optional[TrainState]:
    """Load the checkpoint of ``step`` (the latest if None) into ``bundle``
    and, when ``state`` is given, ``state.optimizer`` (and
    ``state.disc_optimizer``) in place; -> ``state`` at the saved step
    (None without one). The bundle must have the checkpoint's networks: a
    GAN prior's checkpoint restores only into a bundle built with its
    ``pre_trained_generator`` and ``adversarial_prior``, as in the
    reference package. Under fsdp each rank keeps its shard of the
    parameters and of the Adam moments."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    # on the CPU: load_state_dict moves each tensor to its parameter's
    # device, and keeps Adam's step counts on the host
    saved = torch.load(os.path.join(directory, f"{step}.pt"),
                       map_location="cpu", weights_only=True)
    _check_gan_networks(bundle, saved["bundle"])
    with full_params(state):
        bundle.load_state_dict(saved["bundle"])
        if state is not None and state.shards is not None:
            state.shards.scatter()
    if state is None:
        return None
    load_optimizer_state_dict(state, saved["optimizer"])
    if state.disc_optimizer is not None:
        state.disc_optimizer.load_state_dict(saved["disc_optimizer"])
    state.step = int(saved["step"])
    return state


def _check_gan_networks(bundle: ModelBundle, saved: Dict[str, Any]):
    """A checkpoint and a bundle that differ in the GAN prior's networks
    -> ValueError naming the option that builds the missing one."""
    for name, option in (("generator", "pre_trained_generator"),
                         ("discriminator", "adversarial_prior")):
        in_file = any(k.startswith(name + ".") for k in saved)
        in_bundle = getattr(bundle, name) is not None
        if in_file != in_bundle:
            raise ValueError(
                f"the checkpoint {'holds' if in_file else 'has no'} a GAN "
                f"{name} and the run {'has none' if in_file else 'has one'}:"
                f" restore it with{'' if in_file else 'out'} {option}")


# ---------------------------------------------------------------------------
# reference-layout .pth imports
# ---------------------------------------------------------------------------


def _load_pth(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_into(module: nn.Module, state_dict: Dict[str, torch.Tensor],
              may_miss=()):
    """``module.load_state_dict`` that tolerates missing keys only for the
    statistics a reference file does not store (``num_batches_tracked``)
    and the prefixes in ``may_miss``; every key of the file must land."""
    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and not k.startswith(tuple(may_miss))]
    if missing or unexpected:
        raise KeyError(f"state_dict does not match {type(module).__name__}: "
                       f"missing {missing}, unexpected {unexpected}")


def import_resnet_encoder(path: str) -> Dict[str, Any]:
    """Reference encoder ``.pth`` -> {'state_dict': weights under
    ``encoder.`` for a ``ResnetEncoder``, 'meta': the height, width and
    use_stereo entries the reference trainer stores beside them}."""
    sd = _load_pth(path)
    meta = {k: sd.pop(k) for k in ("height", "width", "use_stereo")
            if k in sd}
    return {"state_dict": sd, "meta": meta}


def import_depth_decoder(path: str) -> Dict[str, Any]:
    """Reference DepthDecoder ``.pth`` -> {'state_dict', 'variant'}: the
    layout of ``models.DepthDecoder`` of that variant. A fork decoder
    starts its ModuleList with bare transposed convs (``decoder.0.weight``),
    the upstream one with a ConvBlock (``decoder.0.conv.conv.weight``). The
    fork never saved its BatchNorms, so they keep their values on load; the
    upstream decoder has none."""
    sd = _load_pth(path)
    variant = "fork" if "decoder.0.weight" in sd else "upstream"
    return {"state_dict": sd, "variant": variant}


def import_pose_decoder(path: str) -> Dict[str, Any]:
    """Reference PoseDecoder ``.pth`` -> {'state_dict'}."""
    return {"state_dict": _load_pth(path)}


def import_pose_cnn(path: str) -> Dict[str, Any]:
    """Reference PoseCNN ``.pth`` (``net.0-6``, ``pose_conv``) ->
    {'state_dict'}."""
    return {"state_dict": _load_pth(path)}


def import_generator(path: str) -> Dict[str, Any]:
    """Reference CycleGAN generator ``.pth`` (a ``model`` Sequential) ->
    {'state_dict', 'num_residual_blocks'}: the layout of
    ``models.GeneratorResNet``, whose residual blocks are counted from the
    file's keys (those of each block's first conv), as the reference package
    counts them."""
    sd = _load_pth(path)
    n_res = sum(1 for k in sd if k.endswith(".block.1.weight"))
    return {"state_dict": sd, "num_residual_blocks": n_res}


def load_generator(bundle: ModelBundle, path: str):
    """``import_generator`` of ``path`` into ``bundle.generator``; a file
    with another number of residual blocks than the run's 9 is refused."""
    tree = import_generator(path)
    want = bundle.generator.num_residual_blocks
    if tree["num_residual_blocks"] != want:
        raise ValueError(f"{path} holds a generator of "
                         f"{tree['num_residual_blocks']} residual blocks; "
                         f"the run's has {want}")
    load_into(bundle.generator, tree["state_dict"])


def import_torchvision_resnet(path_or_sd, num_input_images: int = 1
                              ) -> Dict[str, torch.Tensor]:
    """Un-prefixed torchvision ResNet ``.pth`` (the ImageNet zoo layout) ->
    a ``ResnetEncoder`` state_dict. For stacked frames the RGB conv1 kernel
    is tiled across them and divided by their count, as the reference
    does."""
    sd = (dict(path_or_sd) if isinstance(path_or_sd, dict)
          else _load_pth(path_or_sd))
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    if num_input_images > 1:
        w = sd["conv1.weight"]
        sd["conv1.weight"] = torch.cat([w] * num_input_images,
                                       1) / num_input_images
    return {f"encoder.{k}": v for k, v in sd.items()}


# torchvision IMAGENET1K_V1 files, as the torch hub cache names them
IMAGENET_RESNET_FILES = {
    18: "resnet18-f37072fd.pth",
    34: "resnet34-b627a593.pth",
    50: "resnet50-0676ba61.pth",
    101: "resnet101-63fe2227.pth",
    152: "resnet152-394f9c45.pth",
}


def locate_imagenet_weights(num_layers: int = 18,
                            explicit: Optional[str] = None) -> str:
    """-> path to a torchvision ImageNet ResNet ``.pth``: the explicit
    ``--imagenet_weights`` file, else the torch hub cache. It never
    downloads. Raises an actionable FileNotFoundError when neither has
    one."""
    if explicit:
        path = os.path.expanduser(explicit)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"--imagenet_weights {explicit} does not exist")
        return path
    if num_layers not in IMAGENET_RESNET_FILES:
        raise ValueError(f"no ImageNet zoo entry for resnet{num_layers}")
    cache_dir = os.path.join(os.path.expanduser(
        os.environ.get("TORCH_HOME", "~/.cache/torch")), "hub",
        "checkpoints")
    cached = os.path.join(cache_dir, IMAGENET_RESNET_FILES[num_layers])
    if os.path.isfile(cached):
        return cached
    hits = sorted(glob.glob(os.path.join(cache_dir,
                                         f"resnet{num_layers}-*.pth")))
    if hits:
        return hits[0]
    raise FileNotFoundError(
        f"weights_init=pretrained needs the torchvision ImageNet "
        f"resnet{num_layers} weights, and the torch hub cache ({cache_dir}) "
        f"does not have them (this package does not download). Either "
        f"place the file and pass --imagenet_weights <path>, or train from "
        f"random init with --weights_init scratch.")


def load_pth_folder(bundle: ModelBundle, folder: str,
                    models_to_load=("pose_encoder", "pose", "depth",
                                    "encoder"), skip_missing: bool = True,
                    depth_tree: Optional[dict] = None):
    """Load a folder of reference ``<name>.pth`` files into ``bundle``, as
    the reference trainer does for ``load_weights_folder``: a missing file
    is skipped with a message (raises FileNotFoundError unless
    ``skip_missing``), and so is a file of a network the run does not have
    (``pose_encoder`` under a shared or PoseCNN pose network); a depth
    decoder of another variant than the run's raises ValueError.
    ``depth_tree`` is ``import_depth_decoder`` of the folder's ``depth.pth``
    where the caller has read it already."""
    cfg = bundle.cfg
    for name in models_to_load:
        path = os.path.join(folder, f"{name}.pth")
        if not os.path.isfile(path):
            if not skip_missing:
                raise FileNotFoundError(f"Cannot find {path}")
            print(f"Cannot find {path}; skipping")
            continue
        module = getattr(bundle, name, None)
        if module is None and name in ("pose_encoder", "pose"):
            print(f"This run has no {name}; skipping {path}")
            continue
        print(f"Loading {name} weights...")
        if name in ("encoder", "pose_encoder"):
            load_into(module, import_resnet_encoder(path)["state_dict"])
        elif name == "depth":
            tree = depth_tree or import_depth_decoder(path)
            if tree["variant"] != cfg.depth_decoder_variant:
                raise ValueError(
                    f"{path} is a '{tree['variant']}' decoder but the "
                    f"run is configured for "
                    f"'{cfg.depth_decoder_variant}'; pass "
                    f"--depth_decoder_variant {tree['variant']}")
            load_into(module, tree["state_dict"], may_miss=("bn.",))
        elif name == "pose" and cfg.pose_model_type == "posecnn":
            load_into(module, import_pose_cnn(path)["state_dict"])
        elif name == "pose":
            load_into(module, import_pose_decoder(path)["state_dict"])
        else:
            raise ValueError(f"unknown model '{name}' in models_to_load")


def load_weights(bundle: ModelBundle, folder: str,
                 state: Optional[TrainState] = None,
                 models_to_load=("pose_encoder", "pose", "depth", "encoder"),
                 skip_missing: bool = True) -> str:
    """Load ``folder`` into ``bundle``: a checkpoint directory of this
    package (its latest step; the optimizer and step too when ``state`` is
    given) or a folder of reference ``.pth`` files (``load_pth_folder``).
    -> "checkpoint" or "pth"."""
    folder = os.path.expanduser(folder)
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"Cannot find folder {folder}")
    step = latest_step(folder)
    if step is None:
        load_pth_folder(bundle, folder, models_to_load, skip_missing)
        return "pth"
    restore_checkpoint(folder, bundle, state, step)
    return "checkpoint"
