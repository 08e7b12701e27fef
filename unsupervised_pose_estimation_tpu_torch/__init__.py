"""PyTorch/CUDA port of the monodepth framework.

The JAX package ``unsupervised_pose_estimation_tpu`` beside this one is the
reference; this package reproduces its modules in PyTorch, with every Pallas
TPU kernel on the ported path rewritten as a hand-written CUDA kernel for
Hopper (``csrc/``, bound through ``ops.kernels``). It imports nothing of the
JAX package.

Ported so far, for every training option at either compute dtype: the
training entry point (``cli.train`` -> ``train.loop.Trainer``, with
``data``, ``train.checkpoint`` and ``train.logging``) on one device or over
a mesh of processes (``parallel``), the training and validation steps
(``train.step``), the warp ladder, evaluation (``eval``, ``cli``) and
depth serving (``serve.InferenceEngine`` / ``serve.MicroBatcher``).
"""
