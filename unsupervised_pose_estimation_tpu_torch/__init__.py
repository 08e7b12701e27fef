"""PyTorch/CUDA port of the monodepth framework.

The JAX package ``unsupervised_pose_estimation_tpu`` beside this one is the
reference; this package reproduces its modules in PyTorch, with every Pallas
TPU kernel on the ported path rewritten as a hand-written CUDA kernel for
Hopper (``csrc/``, bound through ``ops.kernels``). It imports nothing of the
JAX package.

Ported so far, for the ResNet + fork-decoder + separate-ResNet-pose
configuration in float32: the training entry point (``cli.train`` ->
``train.loop.Trainer``, with ``data``, ``train.checkpoint`` and
``train.logging``), the training and validation steps (``train.step``), the
warp ladder, and depth serving (``serve.InferenceEngine`` /
``serve.MicroBatcher``).
"""
