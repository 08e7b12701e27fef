"""Single-image / folder depth inference:

    python -m unsupervised_pose_estimation_tpu_torch.cli.test_simple \
        --image_path <image or folder> --model_path <checkpoint or .pth folder> \
        [--height 192 --width 192] [--pose_prediction]

Port of ``unsupervised_pose_estimation_tpu/cli/test_simple.py``, with the
same flags and files: each image resized to the model feed (PIL's LANCZOS
bytes, ``data.resample``), ``<name>_disp.npy`` (the scaled disparity at the
min/max depth range) and ``<name>_disp.jpg`` (magma-colour-mapped at the
input resolution, ``data.colormap`` and ``data.jpeg``); with
``--pose_prediction``, the pose of the first two images in
``rot_trans.csv`` and ``transform.csv``. PNG and JPEG images are decoded
with ``data.png`` and ``data.jpeg``; other formats need PIL, imported only
for them. The ``_disp.jpg`` is Pillow's file byte for byte. It runs on
the CUDA device (decoding and resizing through the native host routines);
``main(argv, device="cpu")`` on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np
import torch

from ..config import Options
from ..data.colormap import magma_u8
from ..data.jpeg import write_jpeg
from ..data.png import read_image
from ..data.resample import resize_lanczos
from ..eval.evaluate_depth import load_eval_state
from ..eval.metrics import resize_bilinear_np
from ..ops.geometry import disp_to_depth, transformation_from_parameters
from ..ops.kernels._lib import native_route
from ..train.step import build_infer_step


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Simple testing function for depth prediction")
    parser.add_argument("--image_path", required=True,
                        help="path to a test image or folder of images")
    parser.add_argument("--model_path", required=True,
                        help="checkpoint directory or .pth weights folder")
    parser.add_argument("--ext", default="png",
                        help="image extension to search for in folder")
    parser.add_argument("--num_layers", type=int, default=18)
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--width", type=int, default=192)
    parser.add_argument("--min_depth", type=float, default=0.1)
    parser.add_argument("--max_depth", type=float, default=150.0)
    parser.add_argument("--no_save_npy", action="store_true")
    parser.add_argument("--pose_prediction", action="store_true")
    return parser.parse_args(argv)


def _magma_colormap(x: np.ndarray) -> np.ndarray:
    """The reference CLI's colouring: normalised by the 95th percentile,
    through magma, -> (H, W, 3) uint8."""
    vmax = np.percentile(x, 95)
    normed = np.clip(x / max(vmax, 1e-9), 0, 1)
    return magma_u8(normed)


def test_simple(args, device="cuda"):
    opt = Options(num_layers=args.num_layers, height=args.height,
                  width=args.width, min_depth=args.min_depth,
                  max_depth=args.max_depth,
                  load_weights_folder=args.model_path)
    bundle = load_eval_state(opt, device)
    infer = build_infer_step(bundle)
    dev = next(bundle.parameters()).device
    native = native_route(dev)

    if os.path.isfile(args.image_path):
        paths = [args.image_path]
        out_dir = os.path.dirname(args.image_path)
    elif os.path.isdir(args.image_path):
        paths = sorted(glob.glob(
            os.path.join(args.image_path, f"*.{args.ext}")))
        out_dir = args.image_path
    else:
        raise FileNotFoundError(args.image_path)
    print(f"-> Predicting on {len(paths)} test images")

    def feed(path):
        """-> the (H0, W0) of the image and its (H, W, 3) float feed."""
        img = read_image(path, native)
        small = resize_lanczos(img, opt.height, opt.width, native)
        return img.shape[:2], small.astype(np.float32) / 255.0

    for idx, path in enumerate(paths):
        if path.endswith("_disp.jpg"):
            continue
        (orig_h, orig_w), x = feed(path)
        disp = infer(torch.from_numpy(x[None]).to(dev))[0][0, ..., 0]
        disp = disp.cpu().numpy()
        # resize to source resolution for display
        disp_resized = resize_bilinear_np(disp, orig_h, orig_w)

        name = os.path.splitext(os.path.basename(path))[0]
        if not args.no_save_npy:
            scaled_disp, _ = disp_to_depth(disp, opt.min_depth, opt.max_depth)
            np.save(os.path.join(out_dir, f"{name}_disp.npy"),
                    np.asarray(scaled_disp)[None, None])

        write_jpeg(os.path.join(out_dir, f"{name}_disp.jpg"),
                   _magma_colormap(disp_resized))
        print(f"   Processed {idx + 1} of {len(paths)} images - "
              f"saved prediction to {out_dir}/{name}_disp.jpg")

    if args.pose_prediction and len(paths) >= 2 and \
            bundle.pose_encoder is not None:
        pair = np.concatenate([feed(paths[0])[1], feed(paths[1])[1]], -1)
        x = torch.from_numpy(pair[None]).to(dev).permute(0, 3, 1, 2)
        with torch.inference_mode():
            feats = bundle.pose_encoder(x.contiguous())
            aa, tt = bundle.pose([feats])
            T = transformation_from_parameters(aa[:, 0, 0], tt[:, 0, 0])
        aa, tt, T = (t.cpu().numpy() for t in (aa, tt, T))
        with open(os.path.join(out_dir, "rot_trans.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["axisangle", aa[0, 0, 0].tolist()])
            writer.writerow(["translation", tt[0, 0, 0].tolist()])
        np.savetxt(os.path.join(out_dir, "transform.csv"), T[0],
                   delimiter=",")
    print("-> Done!")


def main(argv=None, device="cuda"):
    test_simple(parse_args(argv), device)


if __name__ == "__main__":
    main()
