"""PyTorch + CUDA port of fmov_pose_tpu for NVIDIA Hopper GPUs.

The layout mirrors ``fmov_pose_tpu``: each module here has a counterpart of
the same path and function names there, which is the reference it is tested
against.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on the ported path is a hand-written CUDA kernel under ``ops/``.

Nothing in this package imports JAX.
"""
