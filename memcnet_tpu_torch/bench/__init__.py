"""Measurement scripts for the port's kernels on the card (not imported by
the package): ``kernel_ab.py`` times K1 and K4 against another checkout and
K1's design steps (``warp_steps.cu``)."""
