"""A seven-frame window into MEMC_Net_VE (``models/memc_net_ve.py``): the
forward takes the list of frames, center at 3, and returns the enhanced
center frame."""

INPUTS = 7


def rectified(model, frames):
    return model(list(frames))
