"""ResNet family (ResNet-18/34/50/101/152), NHWC.

Counterpart of ``apex_tpu/models/resnet.py``, the capability of apex's
flagship example (ResNet-50 ImageNet training under amp O2,
``examples/imagenet/main_amp.py``) as an :class:`torch.nn.Module`:

- NHWC activations and HWIO conv weights, as the JAX package keeps them
  (and the fused kernels read them); the fc kernel is ``[in, classes]``;
- batch-norm scale and bias are parameters, the running mean and var are
  buffers, updated in place (under ``no_grad``) where the JAX model
  returns its new state; the running var takes the unbiased batch
  variance;
- ``forward(x_nhwc)`` follows ``self.training``: eval normalizes with the
  running statistics on the unfused path; training computes batch
  statistics, and with ``fused_conv`` every bottleneck runs the fused
  path — its 1x1 convs through :func:`conv1x1_bn_act` (Kernels J and K on
  the card) and the conv2 of each stride-1 block through
  :func:`conv3x3_bn_act` (L and M), each reading its raw input, applying
  the previous batch norm's normalize+ReLU on the fly and returning its
  output's batch statistics; the three stride-2 blocks keep cuDNN's conv2
  and :func:`bn_sums`;
- conv weights are cast to ``compute_dtype`` a block at a time, batch norm
  and fc stay fp32, and the logits are fp32 (bf16 compute over fp32
  parameters is the amp-O2 configuration).

Synchronized batch norm over a data axis (``axis_name``) comes with the
data-parallel slice and raises until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops._support import resolve_device
from apex_tpu_torch.ops.conv_fused import conv1x1_bn_act, conv3x3_bn_act
from apex_tpu_torch.utils.batch_norm import (bn_apply, bn_from_sums, bn_init,
                                             bn_sums)
from apex_tpu_torch.utils.conv import conv_nhwc, he_init, max_pool_nhwc

__all__ = ["ResNetConfig", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]

# (block type, blocks per stage) by depth: torchvision's layout
_DEPTHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

_STAGE_WIDTHS = (64, 128, 256, 512)


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64                    # stem width
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    # data-parallel axis of synchronized batch norm: not yet in the port
    axis_name: Optional[str] = None
    compute_dtype: torch.dtype = torch.float32   # bf16 = the amp-O2 cast
    # zero-init the last batch-norm scale of each residual block
    # (torchvision's zero_init_residual, the large-batch ResNet-50 recipe)
    zero_init_residual: bool = True
    # train the bottlenecks on the fused conv + batch-norm kernels
    fused_conv: Optional[bool] = None

    @property
    def block(self) -> str:
        return _DEPTHS[self.depth][0]

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return _DEPTHS[self.depth][1]

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1


class BatchNorm(nn.Module):
    """One batch norm: ``scale``/``bias`` parameters, ``mean``/``var``
    buffers (fp32)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        p, s = bn_init(c, device)
        self.scale = nn.Parameter(p["scale"])
        self.bias = nn.Parameter(p["bias"])
        self.register_buffer("mean", s["mean"])
        self.register_buffer("var", s["var"])

    def _p(self):
        return {"scale": self.scale, "bias": self.bias}

    def _s(self):
        return {"mean": self.mean, "var": self.var}

    @torch.no_grad()
    def _update(self, new_s) -> None:
        self.mean.copy_(new_s["mean"])
        self.var.copy_(new_s["var"])

    def forward(self, x, train: bool, config: ResNetConfig):
        """``bn_apply`` on NHWC ``x``; training updates the buffers."""
        y, new_s = bn_apply(self._p(), self._s(), x, train=train,
                            momentum=config.bn_momentum, eps=config.bn_eps,
                            axis_name=config.axis_name)
        if train:
            self._update(new_s)
        return y

    def close(self, sums, n, shift, config: ResNetConfig):
        """``bn_from_sums`` over sums taken around ``shift``: returns the
        normalize's ``(a, b)`` and updates the buffers."""
        a, b, new_s = bn_from_sums(self._p(), self._s(), sums, n, shift=shift,
                                   momentum=config.bn_momentum,
                                   eps=config.bn_eps,
                                   axis_name=config.axis_name)
        self._update(new_s)
        return a, b


class Block(nn.Module):
    """A bottleneck (conv1 1x1, conv2 3x3 with the stride, conv3 1x1) or
    basic (two 3x3) residual block, with a 1x1 downsample where the shape
    changes."""

    def __init__(self, config: ResNetConfig, cin: int, width: int, cout: int,
                 stride: int, generator=None, device=None):
        super().__init__()
        self.stride = stride
        if config.block == "bottleneck":
            convs = [("conv1", (1, 1, cin, width)),
                     ("conv2", (3, 3, width, width)),
                     ("conv3", (1, 1, width, cout))]
        else:
            convs = [("conv1", (3, 3, cin, width)),
                     ("conv2", (3, 3, width, cout))]
        for i, (name, shape) in enumerate(convs):
            setattr(self, name, nn.Parameter(he_init(shape, generator,
                                                     device=device)))
            setattr(self, f"bn{i + 1}", BatchNorm(shape[-1], device))
        if config.zero_init_residual:
            with torch.no_grad():
                getattr(self, f"bn{len(convs)}").scale.zero_()
        self.has_down = stride != 1 or cin != cout
        if self.has_down:
            self.down_conv = nn.Parameter(he_init((1, 1, cin, cout), generator,
                                                  device=device))
            self.down_bn = BatchNorm(cout, device)


class _Stem(nn.Module):
    def __init__(self, width: int, generator=None, device=None):
        super().__init__()
        self.conv = nn.Parameter(he_init((7, 7, 3, width), generator,
                                         device=device))
        self.bn = BatchNorm(width, device)


class _Fc(nn.Module):
    def __init__(self, fan_in: int, classes: int, generator=None,
                 device=None):
        super().__init__()
        draw = torch.randn((fan_in, classes), generator=generator,
                           dtype=torch.float32)
        self.kernel = nn.Parameter((draw * fan_in ** -0.5).to(device))
        self.bias = nn.Parameter(torch.zeros(classes, device=device))


class ResNet(nn.Module):
    """ResNet on ``device`` (``"cuda"`` unless the caller asks for the
    CPU), weights drawn from ``generator``. ``forward(x [N, H, W, 3])``
    returns fp32 logits ``[N, num_classes]``; in training mode it updates
    the batch-norm buffers."""

    def __init__(self, config: ResNetConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.axis_name is not None:
            raise NotImplementedError(
                "synchronized batch norm (axis_name) comes with the "
                "data-parallel slice of the port")
        device = resolve_device(device)
        self.config = config
        self.stem = _Stem(config.width, generator, device)
        cin = config.width
        for si, nblocks in enumerate(config.stage_blocks):
            width = _STAGE_WIDTHS[si]
            cout = width * config.expansion
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Block(config, cin, width, cout, stride,
                                    generator, device))
                cin = cout
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))
        self.fc = _Fc(cin, config.num_classes, generator, device)

    @property
    def device(self) -> torch.device:
        return self.fc.kernel.device

    def stages(self):
        return [getattr(self, f"layer{si + 1}")
                for si in range(len(self.config.stage_blocks))]

    def _w(self, p):
        return p.to(self.config.compute_dtype)

    def _block_apply_fused(self, blk: Block, x):
        """Bottleneck on the fused kernels: each 1x1 conv (and the stride-1
        3x3) reads its raw input, applies the previous batch norm's
        normalize+ReLU on the fly and returns its output's statistics,
        shifted by the running mean (cloned: the op saves its shift for the
        backward, and the buffer is updated in place right after)."""
        cfg = self.config
        s = blk.stride

        def close(bn, sums, n, shift, y=None):
            a, b = bn.close(sums, n, shift, cfg)
            if y is None:
                return a, b
            return y * a.to(y.dtype) + b.to(y.dtype)

        nhw = x.shape[0] * x.shape[1] * x.shape[2]
        sh1 = blk.bn1.mean.clone()
        y1, s1 = conv1x1_bn_act(x, self._w(blk.conv1).reshape(x.shape[-1], -1),
                                stats_shift=sh1)
        a1, b1 = close(blk.bn1, s1, nhw, sh1)
        sh2 = blk.bn2.mean.clone()
        if s == 1:
            y2, s2 = conv3x3_bn_act(y1, self._w(blk.conv2), a1, b1, relu=True,
                                    stats_shift=sh2)
            nhw2 = nhw
        else:
            # the three stride-2 blocks keep cuDNN's conv and a stats pass
            z1 = F.relu(y1 * a1.to(y1.dtype) + b1.to(y1.dtype))
            y2 = conv_nhwc(z1, self._w(blk.conv2), s)
            s2 = bn_sums(y2, sh2)
            nhw2 = y2.shape[0] * y2.shape[1] * y2.shape[2]
        a2, b2 = close(blk.bn2, s2, nhw2, sh2)
        sh3 = blk.bn3.mean.clone()
        y3, s3 = conv1x1_bn_act(y2, self._w(blk.conv3).reshape(y2.shape[-1],
                                                               -1),
                                a2, b2, relu=True, stats_shift=sh3)
        out = close(blk.bn3, s3, nhw2, sh3, y3)
        if blk.has_down:
            xd = x[:, ::s, ::s, :] if s != 1 else x
            shd = blk.down_bn.mean.clone()
            yd, sd = conv1x1_bn_act(
                xd, self._w(blk.down_conv).reshape(x.shape[-1], -1),
                stats_shift=shd)
            residual = close(blk.down_bn, sd, nhw2, shd, yd)
        else:
            residual = x
        return F.relu(out + residual)

    def _block_apply(self, blk: Block, x, train: bool):
        cfg = self.config
        if cfg.block == "bottleneck" and train and cfg.fused_conv:
            return self._block_apply_fused(blk, x)
        basic = cfg.block == "basic"
        out = conv_nhwc(x, self._w(blk.conv1), blk.stride if basic else 1)
        out = F.relu(blk.bn1(out, train, cfg))
        out = conv_nhwc(out, self._w(blk.conv2), 1 if basic else blk.stride)
        out = blk.bn2(out, train, cfg)
        if not basic:
            out = conv_nhwc(F.relu(out), self._w(blk.conv3))
            out = blk.bn3(out, train, cfg)
        if blk.has_down:
            residual = blk.down_bn(conv_nhwc(x, self._w(blk.down_conv),
                                             blk.stride), train, cfg)
        else:
            residual = x
        return F.relu(out + residual)

    def forward(self, x):
        """``x [N, H, W, 3]``, any float dtype -> fp32 logits."""
        cfg = self.config
        train = self.training
        x = x.to(cfg.compute_dtype)
        out = conv_nhwc(x, self._w(self.stem.conv), stride=2)
        out = F.relu(self.stem.bn(out, train, cfg))
        out = max_pool_nhwc(out, 3, 2)
        for stage in self.stages():
            for blk in stage:
                out = self._block_apply(blk, out, train)
        out = out.float().mean(dim=(1, 2))
        return out @ self.fc.kernel + self.fc.bias


def _make(depth):
    def ctor(*, device="cuda", generator: Optional[torch.Generator] = None,
             **kw) -> ResNet:
        return ResNet(ResNetConfig(depth=depth, **kw), device=device,
                      generator=generator)
    ctor.__name__ = f"resnet{depth}"
    ctor.__doc__ = f"ResNet-{depth} (torchvision-equivalent topology)."
    return ctor


resnet18 = _make(18)
resnet34 = _make(34)
resnet50 = _make(50)
resnet101 = _make(101)
resnet152 = _make(152)
