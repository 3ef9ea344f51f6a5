"""A frame pair (x0, x2) into MEMC_Net, MEMC_Net_s or MEMC_Net_star
(``models/memc_net.py``): the forward returns ((blended, rectified), offsets,
filters, occlusions), and the rectified middle frame is the output."""

INPUTS = 2


def rectified(model, frames):
    return model(*frames)[0][1]
