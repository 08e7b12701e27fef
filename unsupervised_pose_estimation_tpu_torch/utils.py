"""Misc utilities: a copy of ``unsupervised_pose_estimation_tpu/utils.py``
(itself mirroring the original repository's ``utils.py``)."""

from __future__ import annotations

import hashlib
import os
import urllib.request
import zipfile

import numpy as np

from .data.split import readlines  # noqa: F401
from .train.logging import normalize_image, sec_to_hm_str  # noqa: F401


def rescale(x: np.ndarray) -> np.ndarray:
    """Per-channel min-max rescale (the original ``utils.py:14-23``)."""
    lo = x.min(axis=tuple(range(x.ndim - 1)), keepdims=True)
    hi = x.max(axis=tuple(range(x.ndim - 1)), keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-12)


# Pretrained monodepth2 model zips (the original ``utils.py:62-94``): folders
# of reference ``.pth`` files, which ``eval.evaluate_depth.load_eval_state``
# and ``train.checkpoint.load_pth_folder`` read.
DOWNLOAD_MODELS = {
    "mono_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/mono_640x192.zip",
        "a964b8356e08a02d009609d9e3928f7c"),
    "stereo_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/stereo_640x192.zip",
        "3dfb76bcff0786e4ec07ac00f658dd07"),
    "mono+stereo_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/mono%2Bstereo_640x192.zip",
        "c024d69012485ed05d7eaa9617a96b81"),
    "mono_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/mono_no_pt_640x192.zip",
        "9c2f071e35027c895a4728358ffc913a"),
    "stereo_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/stereo_no_pt_640x192.zip",
        "41ec2de112905f85541ac33a854742d1"),
    "mono+stereo_no_pt_640x192": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/mono%2Bstereo_no_pt_640x192.zip",
        "46c3b824f541d143a45c37df65fbab0a"),
    "mono_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/mono_1024x320.zip",
        "0ab0766efdfeea89a0d9ea8ba90e1e63"),
    "stereo_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/stereo_1024x320.zip",
        "afc2f2126d70cf3fdf26b550898b501a"),
    "mono+stereo_1024x320": (
        "https://storage.googleapis.com/niantic-lon-static/research/"
        "monodepth2/mono%2Bstereo_1024x320.zip",
        "cdc5fc9b23513c07d5b19235d9ef08f7"),
}


def download_model_if_doesnt_exist(model_name: str,
                                   models_dir: str = "models"):
    """Fetch + verify a pretrained monodepth2 checkpoint (the original
    ``utils.py:62-125``). Raises a clear error in offline environments."""
    if model_name not in DOWNLOAD_MODELS:
        raise ValueError(f"unknown model {model_name}")
    url, md5 = DOWNLOAD_MODELS[model_name]
    model_path = os.path.join(models_dir, model_name)
    os.makedirs(models_dir, exist_ok=True)

    def check(path):
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            return hashlib.md5(f.read()).hexdigest() == md5

    zip_path = model_path + ".zip"
    if not os.path.exists(os.path.join(model_path, "encoder.pth")):
        if not check(zip_path):
            print(f"-> Downloading pretrained model to {zip_path}")
            try:
                urllib.request.urlretrieve(url, zip_path)
            except OSError as e:
                raise RuntimeError(
                    f"cannot download {model_name} (offline?): {e}") from e
        if not check(zip_path):
            raise RuntimeError("Failed to download a file which matches the "
                               "checksum - quitting")
        print("   Unzipping model...")
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(model_path)
        print("   Model unzipped to {}".format(model_path))
