"""memcnet_tpu_torch: the PyTorch / CUDA port of memcnet_tpu for NVIDIA Hopper.

It mirrors the JAX package's module names.  Plain tensor code is PyTorch;
each Pallas TPU kernel on the ported path is a hand-written CUDA kernel for
sm_90a under ``ops/cuda`` (sources in ``csrc``, built at first use).  The
port imports nothing of ``memcnet_tpu`` or ``jax``.

Ported so far: eval-mode serving of MEMC_Net_star, MEMC_Net_s and MEMC_Net
(``cli.runner.build_model`` and ``cli.runner.PaddedInterp``).  Entry points
default to ``device="cuda"``.
"""
