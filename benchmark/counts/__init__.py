"""Operations and bytes of the benchmark's models and kernels, from shapes.

Each model has a module here, named in its configuration's ``counts``, with
``flops(H, W)``: the multiply-adds (two operations each) of every conv and
transposed conv of one sample's output frame at the padded size H x W, as
``torch.utils.flop_counter`` counts them; and ``kernels(B, H, W, esize)``:
for each hand kernel of the program that the forward of B samples runs, the
list of its launches' (bytes, operations, peak) -- each input byte read once,
each output byte written once -- against which its roofline share is read.
"""


def conv_out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def conv(b, cin, cout, k, ho, wo, groups=1):
    """Operations of a conv whose output is ho x wo."""
    return 2 * b * (cin // groups) * cout * k * k * ho * wo


def deconv(b, cin, cout, k, hi, wi):
    """Operations of a transposed conv whose input is hi x wi."""
    return 2 * b * cin * cout * k * k * hi * wi


def unet_convs(blocks, h, w, b=1):
    """(b, cin, cout, 3, h, w) of each 3x3 conv of a MonoNet5 trunk of
    ``blocks`` (reference/layers.py) entered at h x w: max-pools halve,
    upsamples double."""
    convs = []
    for kind, cin, cout in blocks:
        if kind == "uc":
            h, w = 2 * h, 2 * w
        convs.append((b, cin, cout, 3, h, w))
        if kind == "cp":
            h, w = h // 2, w // 2
        elif kind == "cu":
            h, w = 2 * h, 2 * w
    return convs


def unet(blocks, h, w, b=1):
    """Operations of a MonoNet5 trunk of ``blocks`` at h x w."""
    return sum(conv(*c) for c in unet_convs(blocks, h, w, b))


def k1(b, h, w, channels, esize, taps=16):
    """K1 over ``channels`` source channels: sources and filter read in the
    activations' type, the flow as float32, the warped sources written; a
    multiply-add per tap and channel, on the CUDA cores in float32."""
    nbytes = b * h * w * ((channels + taps) * esize + 2 * 4 + channels * esize)
    return nbytes, 2 * b * h * w * channels * taps, "float32"


def k4(b, cin, cout, k, h, w, esize, peak):
    """K4's stride-1 'same' conv: input read, output written, weights and the
    float32 bias read once; the algorithm's multiply-adds."""
    nbytes = b * h * w * (cin + cout) * esize + cout * cin * k * k * esize + 4 * cout
    return nbytes, conv(b, cin, cout, k, h, w), peak
