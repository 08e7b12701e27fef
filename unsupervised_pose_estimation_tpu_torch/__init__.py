"""PyTorch/CUDA port of the monodepth framework.

The JAX package ``unsupervised_pose_estimation_tpu`` beside this one is the
reference; this package reproduces its modules in PyTorch, with every Pallas
TPU kernel on the ported path rewritten as a hand-written CUDA kernel for
Hopper (``csrc/``, bound through ``ops.kernels``). It imports nothing of the
JAX package.

Ported so far: the validation step (``train.step.build_eval_step``) and depth
serving (``serve.InferenceEngine`` / ``serve.MicroBatcher``) for the
ResNet + fork-decoder + separate-ResNet-pose configuration.
"""
