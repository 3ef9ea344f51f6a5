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
checkpoints (``io``) and GOP scheduler (``parallel.gop``); training of all
four models (``model.train()``, ``train``: losses, Adamax with optax's
numbers, train steps, ``build_interp_trainer``, ``fit``, resumable); the whole
op library (``ops``: N1-N11); the host library (``native``: the C++ YUV
reader, built with g++ at first use; ``io.t7_import``; ``utils.flowviz``);
and the parallel layer (``parallel``: ``Mesh``, ``make_mesh``,
``make_mesh_2d``, ``zero1_partition``, ``spatial_tiling``, ``data_parallel``,
the tiled warp and projection on tile entries of K1-K3, ``shard_frames``
and ``gather_frames`` -- every layer of the four models and every op of the
library on the tiles of sharded frames (``parallel.partition``) --, ``ZeroAdamax``,
``DataParallelStep``, ``sharded_train_step``, and the HD720p demo's
``--multihost``).
Entry points and train steps default to ``device="cuda"`` and raise without
CUDA unless the caller asks for the CPU.
"""
