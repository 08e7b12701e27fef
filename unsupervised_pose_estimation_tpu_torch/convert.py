"""Weights of the reference JAX package -> this package's state_dict.

``from_jax`` takes the reference's flax ``params`` and ``batch_stats`` trees
(nested dicts keyed by model name; leaves as numpy arrays, or anything
``np.asarray`` accepts), and with the GAN prior its ``frozen`` generator
and ``disc_params``, and returns the ``state_dict`` of a
``train.bundle.ModelBundle``. It is the inverse of the ``.pth`` importers of
``unsupervised_pose_estimation_tpu/train/checkpoint.py`` (``_conv_w``,
``_deconv_w``, ``_bn``, ``_resnet_tree``, the decoder importers and
``import_generator``), kept here as its own copy. Both packages build
their BatchNorms with eps 1e-5, so the running statistics carry over as
they are.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch


def _conv(k):
    """flax conv (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _deconv(k):
    """flax Deconv2x (kh, kw, out, in) -> torch transposed conv
    (in, out, kh, kw)."""
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _bn(sd, prefix, p, s):
    sd[prefix + ".weight"] = p["scale"]
    sd[prefix + ".bias"] = p["bias"]
    sd[prefix + ".running_mean"] = s["mean"]
    sd[prefix + ".running_var"] = s["var"]
    sd[prefix + ".num_batches_tracked"] = np.array(0, np.int64)


def _resnet(sd, prefix, params, stats):
    pre = prefix + ".encoder."
    sd[pre + "conv1.weight"] = _conv(params["stem"]["conv"]["kernel"])
    _bn(sd, pre + "bn1", params["stem"]["bn"], stats["stem"]["bn"])
    for name, block in params.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if not m:
            continue
        bpre = f"{pre}layer{m.group(1)}.{m.group(2)}."
        for sub, tree in block.items():
            st = stats[name][sub]["bn"]
            if sub == "down":
                sd[bpre + "downsample.0.weight"] = _conv(tree["conv"]["kernel"])
                _bn(sd, bpre + "downsample.1", tree["bn"], st)
            else:
                k = sub[len("cb"):]
                sd[f"{bpre}conv{k}.weight"] = _conv(tree["conv"]["kernel"])
                _bn(sd, f"{bpre}bn{k}", tree["bn"], st)


def _depth(sd, prefix, params, stats):
    """A fork tree (``deconv_*``, ``bn_*``) or an upstream one (neither)."""
    pre = prefix + ".decoder."
    fork = "deconv_4" in params
    convs, heads = (5, 15) if fork else (0, 10)
    for j, i in enumerate(range(4, -1, -1)):
        if fork:
            sd[f"{pre}{j}.weight"] = _deconv(params[f"deconv_{i}"]["kernel"])
            sd[f"{pre}{j}.bias"] = params[f"deconv_{i}"]["bias"]
            _bn(sd, f"{prefix}.bn.{i}", params[f"bn_{i}"], stats[f"bn_{i}"])
        for r in range(2):
            conv = params[f"upconv_{i}_{r}"]["conv3x3"]["conv"]
            k = convs + 2 * j + r
            sd[f"{pre}{k}.conv.conv.weight"] = _conv(conv["kernel"])
            sd[f"{pre}{k}.conv.conv.bias"] = conv["bias"]
    scales = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("dispconv_"))
    for j, s in enumerate(scales):
        conv = params[f"dispconv_{s}"]["conv"]
        sd[f"{pre}{heads + j}.conv.weight"] = _conv(conv["kernel"])
        sd[f"{pre}{heads + j}.conv.bias"] = conv["bias"]


def _pose(sd, prefix, params):
    """A PoseDecoder tree, or a PoseCNN tree (``conv_0-6``, ``pose_conv``)."""
    if "pose_conv" in params:
        names = [(f"net.{i}", f"conv_{i}") for i in range(7)]
        names.append(("pose_conv", "pose_conv"))
    else:
        names = [(f"net.{j}", name) for j, name in enumerate(
            ("squeeze", "pose_0", "pose_1", "pose_2"))]
    for key, name in names:
        sd[f"{prefix}.{key}.weight"] = _conv(params[name]["kernel"])
        sd[f"{prefix}.{key}.bias"] = params[name]["bias"]


def _tensors(sd):
    return OrderedDict((k, torch.tensor(np.array(v))) for k, v in sd.items())


def _conv_bias(sd, key, tree):
    sd[key + ".weight"] = _conv(tree["kernel"])
    sd[key + ".bias"] = tree["bias"]


def generator_from_jax(params: Dict[str, Any]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """A reference GeneratorResNet tree (``initial``, ``down_*``,
    ``res_*``, ``up_*``, ``output``) -> a ``models.GeneratorResNet``
    state_dict (the reference ``model`` Sequential's indices); the number
    of residual blocks is the tree's."""
    n_res = sum(1 for k in params if k.startswith("res_"))
    sd: Dict[str, Any] = OrderedDict()
    for i, name in ((1, "initial"), (4, "down_0"), (7, "down_1"),
                    (11 + n_res, "up_0"), (15 + n_res, "up_1"),
                    (19 + n_res, "output")):
        _conv_bias(sd, f"model.{i}", params[name])
    for r in range(n_res):
        for j, conv in ((1, "conv1"), (5, "conv2")):
            _conv_bias(sd, f"model.{10 + r}.block.{j}",
                       params[f"res_{r}"][conv])
    return _tensors(sd)


def discriminator_from_jax(params: Dict[str, Any]
                           ) -> "OrderedDict[str, torch.Tensor]":
    """A reference PatchGANDiscriminator tree (``block_0-3``, ``final``) ->
    a ``models.PatchGANDiscriminator`` state_dict."""
    sd: Dict[str, Any] = OrderedDict()
    for i, name in ((0, "block_0"), (2, "block_1"), (5, "block_2"),
                    (8, "block_3"), (12, "final")):
        _conv_bias(sd, f"model.{i}", params[name])
    return _tensors(sd)


def from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
             frozen: Optional[Dict[str, Any]] = None,
             disc_params: Optional[Dict[str, Any]] = None
             ) -> "OrderedDict[str, torch.Tensor]":
    """Reference trees {'encoder', 'depth', and those of the run's options
    among 'pose_encoder', 'pose' and 'predictive_mask'}, with a GAN prior
    its ``frozen`` tree ({'pre_trained_generator': ...}) and its
    ``disc_params`` -> a ModelBundle state_dict (float32 CPU tensors)."""
    sd: Dict[str, Any] = OrderedDict()
    _resnet(sd, "encoder", params["encoder"], batch_stats["encoder"])
    _depth(sd, "depth", params["depth"], batch_stats.get("depth", {}))
    if "pose_encoder" in params:
        _resnet(sd, "pose_encoder", params["pose_encoder"],
                batch_stats["pose_encoder"])
    if "pose" in params:
        _pose(sd, "pose", params["pose"])
    if "predictive_mask" in params:
        _depth(sd, "predictive_mask", params["predictive_mask"],
               batch_stats["predictive_mask"])
    sd = _tensors(sd)
    if frozen and "pre_trained_generator" in frozen:
        sd.update((f"generator.{k}", v) for k, v in generator_from_jax(
            frozen["pre_trained_generator"]).items())
    if disc_params is not None:
        sd.update((f"discriminator.{k}", v)
                  for k, v in discriminator_from_jax(disc_params).items())
    return sd
