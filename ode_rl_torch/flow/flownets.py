"""FlowNet2 optical-flow network family.

Counterpart of ``ode_rl_tpu/flow/flownets.py``: FlowNetS, FlowNetC
(correlation, kernels K5-K7), FlowNetSD, FlowNetFusion and the stacks
FlowNetCS, FlowNetCSS and FlowNet2 (resample2d warps and channelnorm
brightness errors, kernel K8). Every module takes and returns NHWC, and
every parameter sits at its flax path (``conv1.conv.weight``), so a flax
tree converted by ``convert.flax_to_torch`` loads with ``strict=True``.

flax infers input widths; the constructors here take them. The convs are
``nn.Conv``/``nn.ConvTranspose`` in JAX, so they are cuDNN calls here
(``nn/conv_stacks.py``), in ``dtype`` with fp32 parameters. leaky_relu has
slope 0.1 throughout.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ode_rl_torch.nn.conv_stacks import Conv, ConvTranspose, leaky_relu
from ode_rl_torch.ops.channelnorm import channelnorm
from ode_rl_torch.ops.correlation import correlation, n_displacements
from ode_rl_torch.ops.resize import resize_bilinear
from ode_rl_torch.ops.warp import resample2d

# Skip widths (finest first), bottom width and deconv widths (coarsest
# first) of the refinement, the same in FlowNetS, C and SD.
_SKIPS = (128, 256, 512, 512)
_BOTTOM = 1024
_DECONVS = (512, 256, 128, 64)
# Input widths of the stacked nets: image pair + warped image + flow +
# brightness error for FlowNetS in a stack; image + two flows, their
# magnitudes and two brightness errors for the fusion net.
_STACKED_S_IN = 3 + 3 + 3 + 2 + 1
_FUSION_IN = 3 + 2 + 2 + 1 + 1 + 1 + 1


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return leaky_relu(x, 0.1)


class _Conv(nn.Module):
    """``nn.Conv`` with (k-1)/2 padding, then leaky_relu(0.1)."""

    def __init__(self, cin: int, feats: int, kernel: int = 3, stride: int = 1,
                 *, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.conv = Conv(cin, feats, kernel, stride=stride,
                         padding=(kernel - 1) // 2, dtype=dtype,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _leaky(self.conv(x))


class _Deconv(nn.Module):
    """4x4 stride-2 'SAME' transposed conv, then leaky_relu(0.1)."""

    def __init__(self, cin: int, feats: int, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.deconv = ConvTranspose(cin, feats, dtype=dtype,
                                    generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _leaky(self.deconv(x))


class _UpFlow(nn.Module):
    """x2 flow upsampling by a 2 -> 2 transposed conv; bias-free in
    FlowNetS only."""

    def __init__(self, use_bias: bool = True, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.upflow = ConvTranspose(2, 2, use_bias=use_bias, dtype=dtype,
                                    generator=generator)

    def forward(self, flow: torch.Tensor) -> torch.Tensor:
        return self.upflow(flow)


def _predict_flow(cin: int, dtype: torch.dtype,
                  generator: torch.Generator) -> Conv:
    return Conv(cin, 2, 3, padding=1, dtype=dtype, generator=generator)


class _Refinement(nn.Module):
    """The expanding part: per scale, deconv the features and upsample the
    flow, concat them with the skip, predict the flow. With
    ``inter_channels`` (FlowNetSD) a 3x3 conv without activation sits
    between the concat and the prediction, while the next deconv still
    reads the concat. Returns [flow2, ..., flow6], finest first."""

    def __init__(self, inter_channels: Sequence[int] = (),
                 upflow_bias: bool = True, *, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.inter = bool(inter_channels)
        kw = dict(dtype=dtype, generator=generator)
        self.predict_flow6 = _predict_flow(_BOTTOM, **kw)
        width = _BOTTOM
        for i, (skip, ch) in enumerate(zip(reversed(_SKIPS), _DECONVS)):
            self.add_module(f"deconv_{i}", _Deconv(width, ch, **kw))
            self.add_module(f"upflow_{i}", _UpFlow(upflow_bias, **kw))
            width = skip + ch + 2
            pred_in = width
            if self.inter:
                self.add_module(f"interconv_{i}", Conv(
                    width, inter_channels[i], 3, padding=1, **kw))
                pred_in = inter_channels[i]
            self.add_module(f"predict_flow_{i}", _predict_flow(pred_in, **kw))

    def forward(self, skips: List[torch.Tensor],
                bottom: torch.Tensor) -> List[torch.Tensor]:
        flow = self.predict_flow6(bottom)
        flows = [flow]
        x = bottom
        for i, skip in enumerate(reversed(skips)):
            up_feat = getattr(self, f"deconv_{i}")(x)
            up_flow = getattr(self, f"upflow_{i}")(flow)
            x = torch.cat([skip, up_feat, up_flow], dim=-1)
            y = getattr(self, f"interconv_{i}")(x) if self.inter else x
            flow = getattr(self, f"predict_flow_{i}")(y)
            flows.append(flow)
        return flows[::-1]


def _contracting(module: nn.Module, plan, kw) -> None:
    """Add the _Conv layers (name, cin, feats, kernel, stride) of a plan."""
    for name, cin, feats, kernel, stride in plan:
        module.add_module(name, _Conv(cin, feats, kernel, stride, **kw))


class FlowNetS(nn.Module):
    """Stacked conv flow net over the channel-concatenated image pair."""

    def __init__(self, in_channels: int = 6, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        _contracting(self, [
            ("conv1", in_channels, 64, 7, 2), ("conv2", 64, 128, 5, 2),
            ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1),
            ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
            ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
            ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1)], kw)
        self.refine = _Refinement(upflow_bias=False, **kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x2 = self.conv2(self.conv1(x))
        x3 = self.conv3_1(self.conv3(x2))
        x4 = self.conv4_1(self.conv4(x3))
        x5 = self.conv5_1(self.conv5(x4))
        x6 = self.conv6_1(self.conv6(x5))
        return self.refine([x2, x3, x4, x5], x6)


class FlowNetC(nn.Module):
    """Correlation flow net: one conv tower applied to both images, the
    cost volume of their features, a redirect conv of image 1's features.

    JAX recomputes conv2(conv1(img1)) for the first skip; this reuses it.
    The values are the same, and the shared weights' gradients sum over
    both uses either way."""

    def __init__(self, max_displacement: int = 20, corr_stride: int = 2, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.max_displacement = max_displacement
        self.corr_stride = corr_stride
        n = n_displacements(max_displacement, corr_stride)
        kw = dict(dtype=dtype, generator=generator)
        _contracting(self, [
            ("conv1", 3, 64, 7, 2), ("conv2", 64, 128, 5, 2),
            ("conv3", 128, 256, 5, 2), ("conv_redir", 256, 32, 1, 1),
            ("conv3_1", 32 + n * n, 256, 3, 1),
            ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
            ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
            ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1)], kw)
        self.refine = _Refinement(**kw)

    def forward(self, img1: torch.Tensor,
                img2: torch.Tensor) -> List[torch.Tensor]:
        f1_2 = self.conv2(self.conv1(img1))
        f1 = self.conv3(f1_2)
        f2 = self.conv3(self.conv2(self.conv1(img2)))
        corr = _leaky(correlation(f1, f2, self.max_displacement,
                                  self.corr_stride))
        x3 = self.conv3_1(torch.cat([self.conv_redir(f1), corr], dim=-1))
        x4 = self.conv4_1(self.conv4(x3))
        x5 = self.conv5_1(self.conv5(x4))
        x6 = self.conv6_1(self.conv6(x5))
        return self.refine([f1_2, x3, x4, x5], x6)


class FlowNetSD(nn.Module):
    """Small-displacement variant over the channel-concatenated image pair:
    all 3x3 convs, inter-conv refinement."""

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        _contracting(self, [
            ("conv0", 6, 64, 3, 1), ("conv1", 64, 64, 3, 2),
            ("conv1_1", 64, 128, 3, 1), ("conv2", 128, 128, 3, 2),
            ("conv2_1", 128, 128, 3, 1), ("conv3", 128, 256, 3, 2),
            ("conv3_1", 256, 256, 3, 1), ("conv4", 256, 512, 3, 2),
            ("conv4_1", 512, 512, 3, 1), ("conv5", 512, 512, 3, 2),
            ("conv5_1", 512, 512, 3, 1), ("conv6", 512, 1024, 3, 2),
            ("conv6_1", 1024, 1024, 3, 1)], kw)
        self.refine = _Refinement(inter_channels=(512, 256, 128, 64), **kw)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x1 = self.conv1_1(self.conv1(self.conv0(x)))
        x2 = self.conv2_1(self.conv2(x1))
        x3 = self.conv3_1(self.conv3(x2))
        x4 = self.conv4_1(self.conv4(x3))
        x5 = self.conv5_1(self.conv5(x4))
        x6 = self.conv6_1(self.conv6(x5))
        return self.refine([x2, x3, x4, x5], x6)


class FlowNetFusion(nn.Module):
    """Shallow fusion net giving the final full-resolution flow. Its
    inter-convs have no activation, each deconv reads the raw concat, and
    the flow is predicted from the inter-conv."""

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        _contracting(self, [
            ("conv0", _FUSION_IN, 64, 3, 1), ("conv1", 64, 64, 3, 2),
            ("conv1_1", 64, 128, 3, 1), ("conv2", 128, 128, 3, 2),
            ("conv2_1", 128, 128, 3, 1)], kw)
        self.predict_flow2 = _predict_flow(128, **kw)
        self.deconv1 = _Deconv(128, 32, **kw)
        self.upflow1 = _UpFlow(**kw)
        self.interconv1 = Conv(128 + 32 + 2, 32, 3, padding=1, **kw)
        self.predict_flow1 = _predict_flow(32, **kw)
        self.deconv0 = _Deconv(128 + 32 + 2, 16, **kw)
        self.upflow0 = _UpFlow(**kw)
        self.interconv0 = Conv(64 + 16 + 2, 16, 3, padding=1, **kw)
        self.predict_flow0 = _predict_flow(16, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.conv0(x)
        x1 = self.conv1_1(self.conv1(x0))
        x2 = self.conv2_1(self.conv2(x1))
        flow2 = self.predict_flow2(x2)
        concat1 = torch.cat([x1, self.deconv1(x2), self.upflow1(flow2)], -1)
        flow1 = self.predict_flow1(self.interconv1(concat1))
        concat0 = torch.cat([x0, self.deconv0(concat1), self.upflow0(flow1)],
                            -1)
        return self.predict_flow0(self.interconv0(concat0))


def _up4(flow: torch.Tensor) -> torch.Tensor:
    """Upsample a 1/4-resolution flow to full resolution, scaling values."""
    b, h, w, c = flow.shape
    return resize_bilinear(flow, 4 * h, 4 * w) * 4.0


def _stack_input(img1, img2, flow):
    """Input of a stacked FlowNetS: both images, image 2 warped by the
    flow, the flow scaled by 0.05 and the brightness error."""
    warped = resample2d(img2, flow)
    diff = channelnorm(img1 - warped)
    return torch.cat([img1, img2, warped, flow * 0.05, diff], dim=-1)


class FlowNetCS(nn.Module):
    """C -> S stack."""

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.flownetc = FlowNetC(dtype=dtype, generator=generator)
        self.flownets1 = FlowNetS(_STACKED_S_IN, dtype=dtype,
                                  generator=generator)

    def forward(self, img1, img2) -> List[torch.Tensor]:
        flow1 = _up4(self.flownetc(img1, img2)[0])
        return self.flownets1(_stack_input(img1, img2, flow1))


class FlowNetCSS(nn.Module):
    """C -> S -> S stack."""

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.flownetcs = FlowNetCS(dtype=dtype, generator=generator)
        self.flownets2 = FlowNetS(_STACKED_S_IN, dtype=dtype,
                                  generator=generator)

    def forward(self, img1, img2) -> List[torch.Tensor]:
        flow2 = _up4(self.flownetcs(img1, img2)[0])
        return self.flownets2(_stack_input(img1, img2, flow2))


class FlowNet2(nn.Module):
    """Full FlowNet2: the C -> S -> S large-displacement branch, the SD
    branch and the fusion net. The images are divided by ``rgb_max`` and
    centred by their per-channel mean over (pair, H, W)."""

    def __init__(self, rgb_max: float = 1.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.rgb_max = rgb_max
        kw = dict(dtype=dtype, generator=generator)
        self.css = FlowNetCSS(**kw)
        self.flownetsd = FlowNetSD(**kw)
        self.fusion = FlowNetFusion(**kw)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        pair = torch.stack([img1, img2], dim=1) / self.rgb_max
        mean = pair.mean(dim=(1, 2, 3), keepdim=True)[:, 0]
        img1n = pair[:, 0] - mean
        img2n = pair[:, 1] - mean

        flow_css = _up4(self.css(img1n, img2n)[0])
        flow_sd = _up4(self.flownetsd(torch.cat([img1n, img2n], -1))[0])
        err_css = channelnorm(img1n - resample2d(img2n, flow_css))
        err_sd = channelnorm(img1n - resample2d(img2n, flow_sd))
        fusion_in = torch.cat(
            [img1n, flow_sd * 0.05, flow_css * 0.05, channelnorm(flow_sd),
             channelnorm(flow_css), err_sd, err_css], dim=-1)
        return self.fusion(fusion_in)
