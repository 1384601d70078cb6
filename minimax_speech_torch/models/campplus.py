"""CAM++ x-vector extractor (D-TDNN with context-aware masking).

Port of minimax_speech_tpu/models/campplus.py, the public 3D-Speaker
CAM++ model (80-bin fbank in, 192-d embedding out): an FCM 2-D conv
front end (frequency / 8), a TDNN stem, three CAM-dense-TDNN blocks with
transit layers, stats pooling (mean and std) and a dense head, with
eval-mode batch norms as stored-stat affines. torch layout: the FCM in
NCHW with H the frequency axis and W time, the rest in NCT. Weights come
from a released torch state dict or a campplus.onnx through
utils/convert.py `campplus_params` (`load_campplus`).

Geometry: feat (B, T, 80) mean-subtracted kaldi fbank -> (B, 192).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4                  # bottleneck = bn_size * growth_rate
    init_channels: int = 128
    m_channels: int = 32              # FCM channels
    block_layers: Tuple[int, ...] = (12, 24, 16)
    block_dilations: Tuple[int, ...] = (1, 2, 2)
    seg_len: int = 100                # CAM segment pooling length


class BNEval(nn.Module):
    """Inference-mode batch norm over dim 1 as a stored-stats affine
    (torch's eval semantics, eps 1e-5), then ReLU unless relu=False."""

    def __init__(self, channels: int, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def init_weights(self, generator):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        shape = (-1,) + (1,) * (x.dim() - 2)
        x = (x - self.mean.view(shape)) * self.gamma.view(shape) \
            / torch.sqrt(self.var.view(shape) + 1e-5) + self.beta.view(shape)
        return F.relu(x) if self.relu else x


class BasicResBlock(nn.Module):
    """FCM residual block; the stride falls on the frequency axis only."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=(stride, 1),
                               padding=1, bias=False)
        self.bn1 = BNEval(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BNEval(planes, relu=False)
        if stride != 1 or in_planes != planes:
            self.shortcut_conv = nn.Conv2d(in_planes, planes, 1,
                                           stride=(stride, 1), bias=False)
            self.shortcut_bn = BNEval(planes, relu=False)
        else:
            self.shortcut_conv = None

    def forward(self, x):  # (B, C, F, T)
        h = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        sc = x if self.shortcut_conv is None \
            else self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(h + sc)


class FCM(nn.Module):
    """2-D conv front end: (B, T, F) -> (B, m_channels * F/8, T), the
    channels C-major (c * F' + f), as torch's reshape(B, C*F, T)."""

    def __init__(self, cfg: CAMPPlusConfig):
        super().__init__()
        m = cfg.m_channels
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False)
        self.bn1 = BNEval(m)
        self.layer1_0 = BasicResBlock(m, m, stride=2)
        self.layer1_1 = BasicResBlock(m, m)
        self.layer2_0 = BasicResBlock(m, m, stride=2)
        self.layer2_1 = BasicResBlock(m, m)
        self.conv2 = nn.Conv2d(m, m, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = BNEval(m)

    def forward(self, feat):
        x = self.bn1(self.conv1(feat.transpose(1, 2)[:, None]))
        for blk in (self.layer1_0, self.layer1_1, self.layer2_0,
                    self.layer2_1):
            x = blk(x)
        x = self.bn2(self.conv2(x))
        b, c, f, t = x.shape
        return x.reshape(b, c * f, t)


def _conv1d(cin, cout, kernel, stride=1, dilation=1, bias=False):
    return nn.Conv1d(cin, cout, kernel, stride=stride,
                     padding=(kernel - 1) // 2 * dilation, dilation=dilation,
                     bias=bias)


class CAMLayer(nn.Module):
    """Context-aware mask: the local conv's output gated by a sigmoid mask
    of the global mean plus the segment-pooled context."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int,
                 dilation: int, seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = _conv1d(bn_channels, out_channels, kernel_size,
                                    dilation=dilation)
        self.linear1 = _conv1d(bn_channels, bn_channels // 2, 1, bias=True)
        self.linear2 = _conv1d(bn_channels // 2, out_channels, 1, bias=True)

    def forward(self, x):  # (B, C, T)
        y = self.linear_local(x)
        context = x.mean(dim=-1, keepdim=True) + self._seg_pool(x)
        m = torch.sigmoid(self.linear2(F.relu(self.linear1(context))))
        return y * m

    def _seg_pool(self, x):
        """avg_pool1d(seg_len, ceil_mode): the last segment divided by its
        true count; then upsampled piecewise-constant and cut to T."""
        b, c, t = x.shape
        s = self.seg_len
        n_seg = -(-t // s)
        xp = F.pad(x, (0, n_seg * s - t))
        counts = np.minimum(np.arange(1, n_seg + 1) * s, t) \
            - np.arange(n_seg) * s
        seg = xp.reshape(b, c, n_seg, s).sum(-1) \
            / torch.as_tensor(counts, dtype=x.dtype, device=x.device)
        return seg.repeat_interleave(s, dim=-1)[..., :t]


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_channels: int,
                 kernel_size: int, dilation: int, seg_len: int = 100):
        super().__init__()
        self.nonlinear1 = BNEval(in_channels)
        self.linear1 = _conv1d(in_channels, bn_channels, 1)
        self.nonlinear2 = BNEval(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, growth_rate, kernel_size,
                                  dilation, seg_len)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(
            self.nonlinear1(x))))


class CAMPPlus(nn.Module):
    def __init__(self, cfg: CAMPPlusConfig = CAMPPlusConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.head = FCM(c)
        f = c.feat_dim
        for _ in range(3):  # the FCM's three stride-2 convs, padding 1
            f = (f + 1) // 2
        self.tdnn_linear = _conv1d(c.m_channels * f, c.init_channels, 5,
                                   stride=2)
        self.tdnn_bn = BNEval(c.init_channels)
        ch = c.init_channels
        for bi, (n_layers, dil) in enumerate(zip(c.block_layers,
                                                 c.block_dilations), 1):
            for li in range(1, n_layers + 1):
                setattr(self, f"block{bi}_layer{li}", CAMDenseTDNNLayer(
                    ch, c.growth_rate, c.bn_size * c.growth_rate, 3, dil,
                    c.seg_len))
                ch += c.growth_rate
            setattr(self, f"transit{bi}_bn", BNEval(ch))
            setattr(self, f"transit{bi}_linear", _conv1d(ch, ch // 2, 1))
            ch //= 2
        self.out_bn = BNEval(ch)
        self.dense_linear = nn.Linear(2 * ch, c.embedding_size, bias=False)
        self.dense_bn = BNEval(c.embedding_size, relu=False)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """feat: (B, T, 80) mean-subtracted kaldi fbank -> (B, 192)."""
        c = self.cfg
        x = self.tdnn_bn(self.tdnn_linear(self.head(feat)))
        for bi, n_layers in enumerate(c.block_layers, 1):
            for li in range(1, n_layers + 1):
                h = getattr(self, f"block{bi}_layer{li}")(x)
                x = torch.cat([x, h], dim=1)
            x = getattr(self, f"transit{bi}_linear")(
                getattr(self, f"transit{bi}_bn")(x))
        x = self.out_bn(x)
        # stats pooling: mean and the unbiased std
        mean = x.mean(dim=-1)
        var = ((x - mean[..., None]) ** 2).sum(-1) / max(x.shape[-1] - 1, 1)
        stats = torch.cat([mean, torch.sqrt(var + 1e-10)], dim=-1)
        return self.dense_bn(self.dense_linear(stats))


def read_campplus_state(path: str) -> dict:
    """{name: numpy array} of CAM++ weights: a campplus.onnx's
    initializers, or a torch state dict (.pt/.bin)."""
    if str(path).endswith(".onnx"):
        from minimax_speech_torch.utils.onnx_reader import \
            read_onnx_initializers
        return read_onnx_initializers(str(path))
    return {k: v.numpy() for k, v in torch.load(
        path, map_location="cpu").items()}


def load_campplus(path: str, device=None) -> CAMPPlus:
    """The default CAM++ with the weights of `path` (an .onnx or a torch
    state dict), in eval mode on `device` (CUDA unless named; raises
    without a GPU)."""
    from minimax_speech_torch.utils.convert import campplus_params
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.params_io import load_flax_params

    device = resolve_device(device)
    model = load_flax_params(CAMPPlus(),
                             campplus_params(read_campplus_state(path)))
    return model.to(device).eval()


def xvector(model: CAMPPlus, audio16: torch.Tensor) -> torch.Tensor:
    """(T,) 16 kHz audio -> (1, 192): kaldi fbank, per-utterance mean
    subtraction, CAM++ (the reference frontend's x-vector)."""
    from minimax_speech_torch.ops.kaldi_fbank import kaldi_fbank

    feat = kaldi_fbank(audio16)
    feat = feat - feat.mean(dim=0, keepdim=True)
    with torch.no_grad():
        return model(feat[None])
