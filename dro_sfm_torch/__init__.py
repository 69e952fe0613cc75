"""dro_sfm_torch: the PyTorch/CUDA port of dro_sfm_tpu.

The JAX package stays the reference; this package imports nothing from it.
Every TPU kernel on a ported path is a hand-written Hopper kernel under
``csrc/`` (built at first use by `dro_sfm_torch.kernels`).
"""
