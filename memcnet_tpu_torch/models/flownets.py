"""FlowNetS: 6-level conv encoder + deconv decoder (port of
memcnet_tpu/models/flownets.py; reference networks/FlowNetS/FlowNetS.py:33-117,
batchNorm=False).  Returns the quarter-resolution 2-channel flow (flow2), or
with ``training=True`` every scale's flow.
State-dict keys match the reference: conv{N}.0.{weight,bias},
deconv{N}.0.*, predict_flow{N}.weight, upsampled_flow{N}_to_{M}.weight.
"""

import torch
from torch import nn

from memcnet_tpu_torch.nn import init as I
from memcnet_tpu_torch.nn import layers as L

# (name, in, out, kernel, stride)
_ENC = [
    ("conv1", 6, 64, 7, 2),
    ("conv2", 64, 128, 5, 2),
    ("conv3", 128, 256, 5, 2),
    ("conv3_1", 256, 256, 3, 1),
    ("conv4", 256, 512, 3, 2),
    ("conv4_1", 512, 512, 3, 1),
    ("conv5", 512, 512, 3, 2),
    ("conv5_1", 512, 512, 3, 1),
    ("conv6", 512, 1024, 3, 2),
    ("conv6_1", 1024, 1024, 3, 1),
]
_DECONV = [("deconv5", 1024, 512), ("deconv4", 1026, 256), ("deconv3", 770, 128), ("deconv2", 386, 64)]
_PRED = [("predict_flow6", 1024), ("predict_flow5", 1026), ("predict_flow4", 770),
         ("predict_flow3", 386), ("predict_flow2", 194)]
_UP = ["upsampled_flow6_to_5", "upsampled_flow5_to_4", "upsampled_flow4_to_3", "upsampled_flow3_to_2"]


class FlowNetS(nn.Module):
    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s in _ENC:
            setattr(self, name, nn.Sequential(nn.Conv2d(cin, cout, k, s, (k - 1) // 2),
                                              nn.LeakyReLU(0.1)))
        for name, cin, cout in _DECONV:
            setattr(self, name, nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1),
                                              nn.LeakyReLU(0.1)))
        for name, cin in _PRED:
            setattr(self, name, nn.Conv2d(cin, 2, 3, 1, 1, bias=False))
        for name in _UP:
            setattr(self, name, nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=False))

    @torch.no_grad()
    def init_params(self, generator):
        """FlowNetS init (FlowNetS.py:67-72): normal(0, 0.02/n), zero biases."""
        for name, *_ in _ENC:
            conv = getattr(self, name)[0]
            conv.weight.copy_(I.flownets_normal(tuple(conv.weight.shape), generator))
            conv.bias.zero_()
        for name, *_ in _DECONV:
            deconv = getattr(self, name)[0]
            deconv.weight.copy_(I.flownets_normal_iohw(tuple(deconv.weight.shape), generator))
            deconv.bias.zero_()
        for name, _ in _PRED:
            m = getattr(self, name)
            m.weight.copy_(I.flownets_normal(tuple(m.weight.shape), generator))
        for name in _UP:
            m = getattr(self, name)
            m.weight.copy_(I.flownets_normal_iohw(tuple(m.weight.shape), generator))

    def forward(self, x, training=False):
        """x: (B, 6, H, W) stacked pair, H and W divisible by 64 ->
        (B, 2, H/4, W/4) flow2 (FlowNetS.py:80-111); with ``training=True``
        the multi-scale tuple (flow2, flow3, flow4, flow5, flow6), as the
        reference's train-mode forward returns for FlowNetS's own multi-scale
        supervision (FlowNetS.py:106-112).  An argument, not the module's
        mode: the MEMC models take flow2 in train mode too."""
        acts = {}
        out = x
        for name, _ci, _co, k, s in _ENC:
            conv = getattr(self, name)[0]
            out = L.leaky_relu(L.conv2d(out, conv.weight, conv.bias, stride=s,
                                        padding=(k - 1) // 2), 0.1)
            acts[name] = out

        def deconv(name, h):
            m = getattr(self, name)[0]
            return L.leaky_relu(L.conv_transpose2d(h, m.weight, m.bias, stride=2, padding=1), 0.1)

        def predict(name, h):
            return L.conv2d(h, getattr(self, name).weight, None, stride=1, padding=1)

        def upflow(name, f):
            return L.conv_transpose2d(f, getattr(self, name).weight, None, stride=2, padding=1)

        out_conv6 = acts["conv6_1"]
        flow6 = predict("predict_flow6", out_conv6)
        concat5 = torch.cat((acts["conv5_1"], deconv("deconv5", out_conv6),
                             upflow("upsampled_flow6_to_5", flow6)), 1)
        flow5 = predict("predict_flow5", concat5)
        concat4 = torch.cat((acts["conv4_1"], deconv("deconv4", concat5),
                             upflow("upsampled_flow5_to_4", flow5)), 1)
        flow4 = predict("predict_flow4", concat4)
        concat3 = torch.cat((acts["conv3_1"], deconv("deconv3", concat4),
                             upflow("upsampled_flow4_to_3", flow4)), 1)
        flow3 = predict("predict_flow3", concat3)
        concat2 = torch.cat((acts["conv2"], deconv("deconv2", concat3),
                             upflow("upsampled_flow3_to_2", flow3)), 1)
        flow2 = predict("predict_flow2", concat2)
        if training:
            return flow2, flow3, flow4, flow5, flow6
        return flow2
