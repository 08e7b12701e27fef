"""PyTorch/CUDA port of the monodepth framework.

The JAX package ``unsupervised_pose_estimation_tpu`` beside this one is the
reference; this package reproduces its modules in PyTorch, with every Pallas
TPU kernel on the ported path rewritten as a hand-written CUDA kernel for
Hopper (``csrc/``, bound through ``ops.kernels``). It imports nothing of the
JAX package.

Ported, for every training option at either compute dtype: the training
entry point (``cli.train`` -> ``train.loop.Trainer``, with ``data``,
``train.checkpoint`` and ``train.logging``) on one device or over a mesh of
processes (``parallel``), the training and validation steps
(``train.step``), the warp ladder, evaluation (``eval``, ``cli``), depth
serving (``serve``: ``InferenceEngine``, ``MicroBatcher``, the HTTP front
end, ``torch.export`` artifacts; ``cli.serve``, ``cli.export_model``), the
files without PIL (``data.png``, a PNG codec; ``data.resample``, PIL's
LANCZOS bytes; ``data.jpeg``; ``data.colormap``; each hot loop also a
native host routine in ``csrc/image_host.cpp``), the frame cache
(``cli.build_frame_cache``), split files (``data.make_splits``),
``cli.test_simple``, ``cli.export_gt_depth`` and ``utils``. PIL is
imported only for JPEG input, the host jitter (``device_augment=False``)
and the lung layout's scene_points TIFF depth.
"""
