"""How each configuration's model is called on one sample, one module per
call convention, named in the configuration's ``call``.

A module here defines:

  INPUTS                       frames in a sample: the driver reads a sample of
                               the clip at offsets 0, g, 2g, ... (INPUTS - 1) g
                               from its first frame, g the traffic's pair_gap
  rectified(model, frames)     the frame the cell counts and checks, (B, 3, H, W),
                               from ``frames``, INPUTS tensors (B, 3, H, W)

No other module of the benchmark calls the model or indexes its output.
"""
