"""ResNet-D backbone (port of spotter_tpu.models.resnet, style "d").

Matches RT-DETR's presnet: deep 3-conv stem, 3x3/2 max pool, and — the "D"
trick — 2x2 ceil-mode average pooling in front of 1x1 projection shortcuts
when downsampling. NCHW inside; frozen BN. The space-to-depth stem (off by
default in the JAX package) is not ported.
"""

import torch
import torch.nn.functional as F
from torch import nn

from spotter_tpu_torch.models.configs import ResNetConfig
from spotter_tpu_torch.models.layers import ConvNorm, get_activation


def avg_pool_2x2_ceil(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2, ceil_mode=True): clipped edge windows divide by their
    actual element count."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual (resnet-18/34)."""

    def __init__(
        self, in_channels: int, out_channels: int, stride: int = 1,
        shortcut: str = "none", hidden_act: str = "relu",
    ) -> None:
        super().__init__()
        self.shortcut_kind = shortcut
        self.act = get_activation(hidden_act)
        self.conv0 = ConvNorm(in_channels, out_channels, 3, stride, activation=hidden_act)
        self.conv1 = ConvNorm(out_channels, out_channels, 3, 1)
        if shortcut == "proj":
            self.shortcut = ConvNorm(in_channels, out_channels, 1, stride)
        elif shortcut == "avgpool_proj":
            self.shortcut = ConvNorm(in_channels, out_channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.conv0(x))
        residual = x
        if self.shortcut_kind == "proj":
            residual = self.shortcut(x)
        elif self.shortcut_kind == "avgpool_proj":
            residual = self.shortcut(avg_pool_2x2_ceil(x))
        return self.act(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand + residual (resnet-50/101)."""

    def __init__(
        self, in_channels: int, out_channels: int, stride: int = 1,
        shortcut: str = "none", downsample_in_bottleneck: bool = False,
        hidden_act: str = "relu",
    ) -> None:
        super().__init__()
        reduced = out_channels // 4
        s1 = stride if downsample_in_bottleneck else 1
        s2 = stride if not downsample_in_bottleneck else 1
        self.shortcut_kind = shortcut
        self.act = get_activation(hidden_act)
        self.conv0 = ConvNorm(in_channels, reduced, 1, s1, activation=hidden_act)
        self.conv1 = ConvNorm(reduced, reduced, 3, s2, activation=hidden_act)
        self.conv2 = ConvNorm(reduced, out_channels, 1, 1)
        if shortcut == "proj":
            self.shortcut = ConvNorm(in_channels, out_channels, 1, stride)
        elif shortcut == "avgpool_proj":
            self.shortcut = ConvNorm(in_channels, out_channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(self.conv0(x)))
        residual = x
        if self.shortcut_kind == "proj":
            residual = self.shortcut(x)
        elif self.shortcut_kind == "avgpool_proj":
            residual = self.shortcut(avg_pool_2x2_ceil(x))
        elif self.shortcut_kind == "avgpool":
            residual = avg_pool_2x2_ceil(x)
        return self.act(y + residual)


def _basic_shortcut(in_ch: int, out_ch: int, stride: int, apply: bool) -> str:
    # modeling_rt_detr_resnet.py RTDetrResNetBasicLayer.__init__ semantics
    if in_ch != out_ch:
        return "avgpool_proj" if apply else "none"
    return "proj" if apply else "none"


def _bottleneck_shortcut(in_ch: int, out_ch: int, stride: int) -> str:
    # RTDetrResNetBottleNeckLayer.__init__: stride==2 always takes the avg-pool
    # path (projection only when shapes change); stride==1 projects iff needed.
    should_project = in_ch != out_ch or stride != 1
    if stride == 2:
        return "avgpool_proj" if should_project else "avgpool"
    return "proj" if should_project else "none"


class ResNetBackbone(nn.Module):
    """NCHW pixels -> feature maps at `config.out_indices` of
    (stem_out, stage1, stage2, stage3, stage4)."""

    def __init__(self, config: ResNetConfig) -> None:
        super().__init__()
        if config.style != "d":
            raise ValueError(f"only the RT-DETR ResNet-D style is ported, not {config.style!r}")
        cfg = self.config = config
        act = cfg.hidden_act
        emb = cfg.embedding_size
        self.stem0 = ConvNorm(cfg.num_channels, emb // 2, 3, 2, activation=act)
        self.stem1 = ConvNorm(emb // 2, emb // 2, 3, 1, activation=act)
        self.stem2 = ConvNorm(emb // 2, emb, 3, 1, activation=act)
        in_ch = emb
        for stage_idx, (out_ch, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
            stride = 2 if (stage_idx > 0 or cfg.downsample_in_first_stage) else 1
            for block_idx in range(depth):
                block_stride = stride if block_idx == 0 else 1
                block_in = in_ch if block_idx == 0 else out_ch
                if cfg.layer_type == "bottleneck":
                    shortcut = (
                        _bottleneck_shortcut(block_in, out_ch, block_stride)
                        if block_idx == 0 else "none"
                    )
                    block = BottleneckBlock(
                        block_in, out_ch, block_stride, shortcut,
                        cfg.downsample_in_bottleneck, act,
                    )
                else:
                    shortcut = _basic_shortcut(block_in, out_ch, block_stride, block_idx == 0)
                    block = BasicBlock(block_in, out_ch, block_stride, shortcut, act)
                setattr(self, f"stage{stage_idx}_block{block_idx}", block)
            in_ch = out_ch
        channels = (emb, *cfg.hidden_sizes)
        self.out_channels = tuple(channels[i] for i in cfg.out_indices)

    def forward(self, pixel_values: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.config
        x = self.stem2(self.stem1(self.stem0(pixel_values)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as flax's max_pool
        hidden_states = [x]
        for stage_idx, depth in enumerate(cfg.depths):
            for block_idx in range(depth):
                x = getattr(self, f"stage{stage_idx}_block{block_idx}")(x)
            hidden_states.append(x)
        return [hidden_states[i] for i in cfg.out_indices]
