"""memcnet_tpu_torch: the PyTorch / CUDA port of memcnet_tpu for NVIDIA Hopper.

It mirrors the JAX package's module names.  Plain tensor code is PyTorch;
each Pallas TPU kernel on the ported path is a hand-written CUDA kernel for
sm_90a under ``ops/cuda`` (sources in ``csrc``, built at first use).  The
port imports nothing of ``memcnet_tpu`` or ``jax``.

Ported so far: eval-mode serving of all four models, MEMC_Net_star,
MEMC_Net_s and MEMC_Net (``cli.runner.PaddedInterp``) and MEMC_Net_VE
(``cli.runner.PaddedVE``), and the three demos users start it from:
``python -m memcnet_tpu_torch.cli.demo_middlebury``, ``demo_hd720p`` and
``demo_vimeo_ve``, with their config (``utils.config``), readers
(``data``), metrics (``metrics``), PNG I/O (``io.png``), ``.pth`` import and
checkpoints (``io``) and GOP scheduler (``parallel.gop``).  Entry points
default to ``device="cuda"`` and raise without CUDA unless the caller asks
for the CPU.
"""
