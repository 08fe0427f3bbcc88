"""The plain reference of the multimodal SAM-Adapter segmentor.

Written from the architecture (SAM ViT-L with windowed and global
attention and decomposed relative positions, ViT-Adapter's injectors and
extractors on multi-scale deformable attention, a twin ConvNeXt with the
RoadFormer2 fusion neck as the spatial prior, the SegFormer head, and the
PIDNet-style OHEM cross entropy), in plain `torch` operations and no
kernels, caches or batching tricks. It imports nothing of the program it
judges. Parameter and buffer names are the reference checkpoint's keys,
which the program shares, so one state dict loads into both.

Every matrix product, convolution and einsum goes through `Products`:
float32 with TF32 off by default, or, for the benchmark's control, each
operand rounded to float8 e4m3 with a per-tensor scale first (the next
precision below the bfloat16 that the configurations serve and train in;
the backward takes the rounded operands and float32 gradients).

Dropout and stochastic depth in train mode draw their masks as the
configuration defines them: the i-th dropout module in module order is
seeded fold_in(key, i) (splitmix64), and sample b's mask is
`torch.rand(mask shape)` from a generator seeded fold_in(that seed, b).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_MASK64 = (1 << 64) - 1
FP8_MAX = 448.0


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A 63-bit key from `key` and `data`."""
    return _splitmix64((key & _MASK64) ^ _splitmix64(data & _MASK64)) >> 1


class Products:
    """The precision of every product: `fp8` False computes in the
    operands' dtype (float32), True rounds both operands to float8 e4m3
    (scaled so that each tensor's largest magnitude maps to 448) first."""
    fp8 = False


def _q(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale when
    `Products.fp8`; gradients pass through unrounded (float32)."""
    if not Products.fp8:
        return t
    with torch.no_grad():
        scale = t.abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach() if t.requires_grad else q


def linear(x, w, b=None):
    return F.linear(_q(x), _q(w), b)


def conv2d(x, w, b=None, stride=1, padding=0, groups=1):
    return F.conv2d(_q(x), _q(w), b, stride, padding, 1, groups)


def matmul(a, b):
    return torch.matmul(_q(a), _q(b))


def einsum(eq, a, b):
    return torch.einsum(eq, _q(a), _q(b))


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(_q(x), _q(self.weight), self.bias,
                                  self.stride)


def resize(x, hw, mode="bilinear"):
    """Half-pixel resize of an NCHW map (align_corners False)."""
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[-2:]) == hw:
        return x
    return F.interpolate(x, size=hw, mode=mode, align_corners=False)


# ------------------------------------------------------------------ layers

class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map."""

    def __init__(self, channels, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class KeyedDropout(nn.Module):
    """Dropout with masks from the step's key (see the module docstring):
    where(u < keep, x / keep, 0), u of shape (1, *x.shape[1:]) a sample."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = rate
        self.seed: Optional[int] = None

    def mask_shape(self, x):
        return (1,) + tuple(x.shape[1:])

    def forward(self, x):
        if not self.training or self.rate == 0:
            return x
        keep = 1.0 - self.rate
        g = torch.Generator(device=x.device)
        u = torch.cat([torch.rand(self.mask_shape(x), device=x.device,
                                  generator=g.manual_seed(
                                      fold_in(self.seed, b)))
                       for b in range(x.shape[0])])
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class DropPath(KeyedDropout):
    """Stochastic depth: whole samples dropped."""

    def mask_shape(self, x):
        return (1,) * x.dim()


def set_dropout_key(model: nn.Module, key: int) -> None:
    for i, m in enumerate(x for x in model.modules()
                          if isinstance(x, KeyedDropout)):
        m.seed = fold_in(key, i)


class BatchNorm2d(nn.BatchNorm2d):
    """Train mode: the batch's statistics, biased variance; the running
    statistics move by momentum 0.1 towards the batch's mean and biased
    variance. Eval mode: the running statistics."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked.add_(1)
        y = (x - mean[:, None, None]) * torch.rsqrt(var[:, None, None]
                                                    + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class Scale(nn.Module):
    def __init__(self, init_value=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale


class Scale2(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale1 = nn.Parameter(torch.tensor(1.0))
        self.scale2 = nn.Parameter(torch.tensor(1.0))

    def forward(self, x, y):
        return x * self.scale1 + y * self.scale2


class ConvNormAct(nn.Module):
    """Conv -> BatchNorm ('bn') or GroupNorm ('gn') -> ReLU; the conv has a
    bias only without a norm."""

    def __init__(self, cin, cout, k=1, norm=None, gn_groups=32):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, 1, k // 2, bias=norm is None)
        self.norm_name = norm
        if norm == "bn":
            self.bn = BatchNorm2d(cout, eps=1e-5)
        elif norm == "gn":
            self.gn = nn.GroupNorm(gn_groups, cout, eps=1e-5)

    def forward(self, x):
        x = self.conv(x)
        if self.norm_name == "bn":
            x = self.bn(x)
        elif self.norm_name == "gn":
            x = self.gn(x)
        return F.relu(x)


# ----------------------------------------------------------------- SAM ViT

def window_partition(x, ws):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(win, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = win.shape[0] // (Hp * Wp // ws // ws)
    x = win.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def get_rel_pos(q_size, k_size, rel_pos):
    """(q_size, k_size, C) rows of the table for every offset, the table
    linearly resized to 2 * max(q, k) - 1 rows first when it differs."""
    n = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != n:
        rel_pos = F.interpolate(rel_pos.t()[None], size=n, mode="linear",
                                align_corners=False)[0].t()
    q = torch.arange(q_size, device=rel_pos.device)[:, None] * max(
        k_size / q_size, 1.0)
    k = torch.arange(k_size, device=rel_pos.device)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class Attention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias on (B, H, W,
    C) (B folding the windows of a windowed block)."""

    def __init__(self, dim, heads, input_size):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  dim // heads))

    def forward(self, x):
        B, H, W, C = x.shape
        M, N = self.heads, H * W
        qkv = self.qkv(x).reshape(B, N, 3, M, C // M).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * M, N, C // M).unbind(0)
        attn = matmul(q * self.scale, k.transpose(-2, -1))
        Rh = get_rel_pos(H, H, self.rel_pos_h)
        Rw = get_rel_pos(W, W, self.rel_pos_w)
        rq = q.reshape(B * M, H, W, C // M)
        rel_h = einsum("bhwc,hkc->bhwk", rq, Rh)
        rel_w = einsum("bhwc,wkc->bhwk", rq, Rw)
        attn = (attn.view(B * M, H, W, H, W) + rel_h[..., :, None]
                + rel_w[..., None, :]).view(B * M, N, N).softmax(-1)
        o = matmul(attn, v).view(B, M, N, C // M).transpose(1, 2)
        return self.proj(o.reshape(B, H, W, C))


class MLPBlock(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, window, grid):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, (window, window) if window
                              else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x, H, W):
        B, N, C = x.shape
        x = x.view(B, H, W, C)
        y = self.norm1(x)
        if self.window:
            y, pad_hw = window_partition(y, self.window)
        y = self.attn(y)
        if self.window:
            y = window_unpartition(y, self.window, pad_hw, (H, W))
        x = x + y
        x = x + self.mlp(self.norm2(x))
        return x.reshape(B, N, C)


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = Conv2d(cin, dim, patch, patch)

    def forward(self, x):
        x = self.proj(x)
        return x.flatten(2).transpose(1, 2), x.shape[2], x.shape[3]


# ------------------------------------------------- deformable attention

def reference_points(shapes, device):
    """Pixel-centre points per level, normalised, as (x, y):
    (1, sum(HW), 2)."""
    pts = []
    for H, W in shapes:
        ys = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
    return torch.cat(pts)[None]


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention: per query, head, level and point
    an offset from the reference point (in level pixels) and a weight
    (softmax over levels x points); values sampled bilinearly with zero
    padding (grid_sample, align_corners False), weighted and summed."""

    def __init__(self, dim, levels, heads, points, ratio):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        dv = int(dim * ratio)
        self.sampling_offsets = Linear(dim, heads * levels * points * 2)
        self.attention_weights = Linear(dim, heads * levels * points)
        self.value_proj = Linear(dim, dv)
        self.output_proj = Linear(dv, dim)

    def forward(self, query, ref, feat, shapes):
        B, Lq, _ = query.shape
        L, M, P = self.levels, self.heads, self.points
        value = self.value_proj(feat)
        D = value.shape[-1] // M
        offs = self.sampling_offsets(query).view(B, Lq, M, L, P, 2)
        attn = self.attention_weights(query).view(B, Lq, M, L * P)
        attn = attn.softmax(-1).view(B, Lq, M, L, P)
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=offs.dtype,
                          device=offs.device)
        loc = ref[:, :, None, None, None, :] + offs / wh[:, None, :]
        grids = 2 * loc - 1
        values = value.split([h * w for h, w in shapes], dim=1)
        out = 0
        for lvl, (h, w) in enumerate(shapes):
            v = values[lvl].reshape(B, h * w, M, D).permute(0, 2, 3, 1)
            v = v.reshape(B * M, D, h, w)
            g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
            s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                              align_corners=False)   # (B M, D, Lq, P)
            a = attn[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
            out = out + (s * a[:, None]).sum(-1)
        out = out.view(B, M * D, Lq).transpose(1, 2)
        return self.output_proj(out)


# ----------------------------------------------------------------- adapter

class DWConvMS(nn.Module):
    """A shared 3x3 depthwise conv over the 16n / 4n / n token split of
    the pyramid stream [c2, c3, c4]."""

    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, H, W):
        B, N, C = x.shape
        n = N // 21
        parts = []
        for lo, hi, h, w in ((0, 16 * n, 2 * H, 2 * W),
                             (16 * n, 20 * n, H, W),
                             (20 * n, N, H // 2, W // 2)):
            t = x[:, lo:hi].transpose(1, 2).reshape(B, C, h, w)
            parts.append(self.dwconv(t).flatten(2).transpose(1, 2))
        return torch.cat(parts, dim=1)


class ConvFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConvMS(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, H, W):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), H, W)))


class Injector(nn.Module):
    def __init__(self, dim, heads, points, levels, ratio):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttention(dim, levels, heads, points, ratio)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, query, feat, hw, shapes):
        ref = reference_points([hw], query.device)
        attn = self.attn(self.query_norm(query), ref, self.feat_norm(feat),
                         shapes)
        return query + self.gamma * attn


class Extractor(nn.Module):
    def __init__(self, dim, heads, points, ratio, cffn_ratio, drop_path):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttention(dim, 1, heads, points, ratio)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio))
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.drop_path = DropPath(drop_path)

    def forward(self, query, feat, shapes, hw):
        ref = reference_points(shapes, query.device)
        query = query + self.attn(self.query_norm(query), ref,
                                  self.feat_norm(feat), [hw])
        return query + self.drop_path(self.ffn(self.ffn_norm(query), *hw))


class InteractionBlock(nn.Module):
    def __init__(self, dim, heads, points, ratio, cffn_ratio, extra,
                 drop_path):
        super().__init__()
        self.injector = Injector(dim, heads, points, 3, ratio)
        self.extractor = Extractor(dim, heads, points, ratio, cffn_ratio,
                                   drop_path)
        self.extra_extractors = nn.ModuleList(
            Extractor(dim, heads, points, ratio, cffn_ratio, drop_path)
            for _ in range(2 if extra else 0))

    def forward(self, x, c, blocks, hw, shapes):
        x = self.injector(x, c, hw, shapes)
        for blk in blocks:
            x = blk(x, *hw)
        for ext in (self.extractor, *self.extra_extractors):
            c = ext(c, x, shapes, hw)
        return x, c


# ------------------------------------------------------------ twin ConvNeXt

CONVNEXT_ARCHS = {
    "atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
}


class ConvNeXtBlock(nn.Module):
    """On an NHWC map: x + drop_path(gamma * fc2(gelu(fc1(LN(dwconv7(x))))))."""

    def __init__(self, C, drop_path):
        super().__init__()
        self.depthwise_conv = Conv2d(C, C, 7, 1, 3, groups=C)
        self.norm = nn.LayerNorm(C, eps=1e-6)
        self.pointwise_conv1 = Linear(C, 4 * C)
        self.pointwise_conv2 = Linear(4 * C, C)
        self.gamma = nn.Parameter(torch.ones(C))
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        y = self.depthwise_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pointwise_conv2(F.gelu(self.pointwise_conv1(self.norm(y))))
        return x + self.drop_path(y * self.gamma)


class TwinConvNeXt(nn.Module):
    def __init__(self, arch, in_chans, drop_path_rate):
        super().__init__()
        depths, chans = CONVNEXT_ARCHS[arch]
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        starts = [sum(depths[:i]) for i in range(4)]
        for br, cin in zip(("x", "y"), in_chans):
            down = nn.ModuleList([nn.Sequential(Conv2d(cin, chans[0], 4, 4),
                                                LayerNorm2d(chans[0]))])
            for i in range(1, 4):
                down.append(nn.Sequential(LayerNorm2d(chans[i - 1]),
                                          Conv2d(chans[i - 1], chans[i], 2,
                                                 2)))
            setattr(self, f"downsample_layers_{br}", down)
            setattr(self, f"stages_{br}", nn.ModuleList(
                nn.Sequential(*[ConvNeXtBlock(c, dpr[s + j])
                                for j in range(d)])
                for d, c, s in zip(depths, chans, starts)))
            for i, c in enumerate(chans):
                setattr(self, f"norm_{br}{i}", LayerNorm2d(c))

    def _branch(self, br, x):
        down = getattr(self, f"downsample_layers_{br}")
        stages = getattr(self, f"stages_{br}")
        outs = []
        for i in range(4):
            x = down[i](x)
            x = stages[i](x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            outs.append(getattr(self, f"norm_{br}{i}")(x))
        return outs

    def forward(self, x, y):
        return [torch.cat([a, b], 1) for a, b in
                zip(self._branch("x", x), self._branch("y", y))]


# ------------------------------------------------------------- fusion neck

class _Body(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(C))
        self.bias = nn.Parameter(torch.zeros(C))


class RestormerLayerNorm(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.body = _Body(C)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.body.weight, self.body.bias,
                         1e-5)
        return x.permute(0, 3, 1, 2)


class ChannelAttention(nn.Module):
    """Transposed attention over channels: grouped 1x1 and 3x3 qkv, q and k
    L2-normalised over space per head, a learned temperature per head."""

    def __init__(self, dim, heads, groups):
        super().__init__()
        self.heads = heads
        self.qkv1 = Conv2d(dim, 3 * dim, 1, groups=groups, bias=False)
        self.qkv2 = Conv2d(3 * dim, 3 * dim, 3, 1, 1, groups=groups,
                           bias=False)
        self.proj = Conv2d(dim, dim, 1, bias=False)
        self.scale = nn.Parameter(torch.ones(heads, 1, 1))
        self.scale2 = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        B, C, H, W = x.shape
        q, k, v = self.qkv2(self.qkv1(x)).chunk(3, dim=1)
        shape = (B, self.heads, C // self.heads, H * W)
        q = F.normalize(q.reshape(shape), dim=-1)
        k = F.normalize(k.reshape(shape), dim=-1)
        attn = (matmul(q, k.transpose(-2, -1)) * self.scale).softmax(-1)
        out = self.proj(matmul(attn, v.reshape(shape)).reshape(B, C, H, W))
        return x + out * self.scale2


class GFE(nn.Module):
    def __init__(self, dim, heads, groups):
        super().__init__()
        self.norm1 = RestormerLayerNorm(dim)
        self.attn = ChannelAttention(dim, heads, groups)

    def forward(self, x):
        return x + self.attn(self.norm1(x))


class MobileNetV2Block(nn.Module):
    def __init__(self, C):
        super().__init__()
        h = 2 * C
        self.bottleneckBlock = nn.Sequential(
            Conv2d(C, h, 1, bias=False), nn.ReLU6(),
            Conv2d(h, h, 3, 1, 1, groups=h, bias=False), nn.ReLU6(),
            Conv2d(h, C, 1, bias=False))
        self.scale = nn.Parameter(torch.tensor(0.0))

    def forward(self, x):
        return self.bottleneckBlock(x) * self.scale + x


class GFFM(nn.Module):
    """Bidirectional cross-modal channel attention, then a LayerNorm over
    the flattened spatial axis."""

    def __init__(self, hw):
        super().__init__()
        self.gammax = Scale(0.0)
        self.gammay = Scale(0.0)
        self.norm = nn.LayerNorm(hw, eps=1e-5)

    def forward(self, xy):
        B, C2, H, W = xy.shape
        x, y = xy.chunk(2, dim=1)
        fx, fy = x.reshape(B, C2 // 2, H * W), y.reshape(B, C2 // 2, H * W)
        ax = matmul(fx, fy.transpose(1, 2)).softmax(-1)
        ay = matmul(fy, fx.transpose(1, 2)).softmax(-1)
        outx = self.gammax(matmul(ax, fy)) + fx
        outy = self.gammay(matmul(ay, fx)) + fy
        return self.norm(torch.cat([outx, outy], 1)).reshape(B, C2, H, W)


class GatedDWConvMlp(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.project_in = Conv2d(C, 2 * C, 1, bias=False)
        self.dwconv = Conv2d(2 * C, 2 * C, 3, 1, 1, groups=C, bias=False)
        self.project_out = Conv2d(C, C, 1, bias=False)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class FFRM(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.conv_atten = ConvNormAct(C, C, 1, norm="gn",
                                      gn_groups=math.gcd(32, C))

    def forward(self, x):
        return x + x * torch.sigmoid(self.conv_atten(
            x.mean(dim=(2, 3), keepdim=True)))


class CoordinateAttention(nn.Module):
    def __init__(self, C, reduction=32):
        super().__init__()
        mip = max(8, C // reduction)
        self.conv1 = Conv2d(C, mip, 1)
        self.bn1 = BatchNorm2d(mip, eps=1e-5)
        self.conv_h = Conv2d(mip, C, 1)
        self.conv_w = Conv2d(mip, C, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        x_h = x.mean(dim=3, keepdim=True)
        x_w = x.mean(dim=2, keepdim=True).transpose(2, 3)
        y = self.bn1(self.conv1(torch.cat([x_h, x_w], dim=2)))
        y = y * F.relu6(y + 3.0) / 6.0
        a_h = torch.sigmoid(self.conv_h(y[:, :, :H]))
        a_w = torch.sigmoid(self.conv_w(y[:, :, H:])).transpose(2, 3)
        return x + x * a_w * a_h


class _CABlock(nn.Module):
    def __init__(self, C):
        super().__init__()
        self.coord_atten = CoordinateAttention(C)

    def forward(self, x):
        return self.coord_atten(x)


class RoadFormer2Neck(nn.Module):
    def __init__(self, in_channels, feat_hw):
        super().__init__()
        halves = [c // 2 for c in in_channels]
        for mod in ("rgb", "sne"):
            setattr(self, f"global_feature_encoder_{mod}", nn.ModuleList(
                GFE(h, 8, math.gcd(32, h)) for h in halves))
            setattr(self, f"local_feature_encoder_{mod}", nn.ModuleList(
                MobileNetV2Block(h) for h in halves))
        self.fuse_blocks = nn.ModuleList(GFFM(hw) for hw in feat_hw)
        self.detail_feature_extractions = nn.ModuleList(
            GatedDWConvMlp(c) for c in in_channels)
        self.enhance_blocks = nn.ModuleList(FFRM(c) for c in in_channels)
        self.ca_blocks = nn.ModuleList(_CABlock(c) for c in in_channels)
        self.scale_layers = nn.ModuleList(Scale2() for _ in in_channels)

    def forward(self, feats):
        outs = []
        for i, feat in enumerate(feats):
            rgb, sne = feat.chunk(2, dim=1)
            g = torch.cat([self.global_feature_encoder_rgb[i](rgb),
                           self.global_feature_encoder_sne[i](sne)], 1)
            loc = torch.cat([self.local_feature_encoder_rgb[i](rgb),
                             self.local_feature_encoder_sne[i](sne)], 1)
            g = self.enhance_blocks[i](self.fuse_blocks[i](g))
            loc = self.detail_feature_extractions[i](loc)
            outs.append(self.ca_blocks[i](self.scale_layers[i](g, loc)))
        return outs


class SpatialPrior(nn.Module):
    """Twin ConvNeXt + fusion neck + 1x1 projections to the ViT width: c1
    an NCHW map, c2..c4 token streams."""

    def __init__(self, dim, arch, img_size, in_chans, drop_path_rate):
        super().__init__()
        concat = [2 * c for c in CONVNEXT_ARCHS[arch][1]]
        self.twin_conv = TwinConvNeXt(arch, in_chans, drop_path_rate)
        self.smart_fusion = RoadFormer2Neck(
            concat, [(img_size // 2 ** (i + 2)) ** 2 for i in range(4)])
        for i, c in enumerate(concat):
            setattr(self, f"fc{i + 1}", Conv2d(c, dim, 1))

    def forward(self, x, y):
        feats = self.smart_fusion(self.twin_conv(x, y))
        outs = [getattr(self, f"fc{i + 1}")(f) for i, f in enumerate(feats)]
        return [outs[0]] + [o.flatten(2).transpose(1, 2) for o in outs[1:]]


# ---------------------------------------------------------------- backbone

class Backbone(nn.Module):
    def __init__(self, img_size=1024, patch_size=16, embed_dim=1024,
                 depth=24, num_heads=16, mlp_ratio=4.0, n_points=4,
                 deform_num_heads=16, cffn_ratio=0.25, deform_ratio=0.5,
                 interaction_indexes=((0, 5), (6, 11), (12, 17), (18, 23)),
                 global_attn_indexes=(5, 11, 17, 23), window_size=14,
                 pretrained_size=1024, modalities_ch=(3, 3), arch="small",
                 drop_path_rate=0.3, conv_drop_path_rate=0.4, drop_rate=0.0,
                 **_unused):
        super().__init__()
        if len(modalities_ch) < 2:
            raise ValueError("the reference holds the multimodal prior only")
        self.embed_dim = embed_dim
        self.rgb_ch = modalities_ch[0]
        self.interaction_indexes = [tuple(s) for s in interaction_indexes]
        grid = pretrained_size // patch_size
        self.spm = SpatialPrior(embed_dim, arch, img_size,
                                (modalities_ch[0], sum(modalities_ch[1:])),
                                conv_drop_path_rate)
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim))
        self.patch_embed = PatchEmbed(self.rgb_ch, embed_dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.pos_drop = KeyedDropout(drop_rate)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio,
                     0 if i in global_attn_indexes else window_size,
                     (grid, grid)) for i in range(depth))
        n = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(embed_dim, deform_num_heads, n_points,
                             deform_ratio, cffn_ratio, si == n - 1,
                             drop_path_rate) for si in range(n))
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, 2)
        for i in range(1, 5):
            setattr(self, f"norm{i}", BatchNorm2d(embed_dim, eps=1e-5))

    def forward(self, x):
        """x (B, C_in, H, W) -> [f1, f2, f3, f4] NCHW at strides 4..32."""
        B, _, Hi, Wi = x.shape
        E = self.embed_dim
        c1, c2, c3, c4 = self.spm(x[:, :self.rgb_ch], x[:, self.rgb_ch:])
        c = torch.cat([c2 + self.level_embed[0], c3 + self.level_embed[1],
                       c4 + self.level_embed[2]], dim=1)
        n2, n3 = c2.shape[1], c3.shape[1]
        tokens, H, W = self.patch_embed(x[:, :self.rgb_ch])
        pos = self.pos_embed
        if pos.shape[1:3] != (H, W):
            pos = resize(pos.permute(0, 3, 1, 2), (H, W),
                         "bicubic").permute(0, 2, 3, 1)
        xt = self.pos_drop(tokens + pos.reshape(1, H * W, -1))
        shapes = [(Hi // 8, Wi // 8), (Hi // 16, Wi // 16),
                  (Hi // 32, Wi // 32)]
        outs = []
        for si, (lo, hi) in enumerate(self.interaction_indexes):
            xt, c = self.interactions[si](xt, c, self.blocks[lo:hi + 1],
                                          (H, W), shapes)
            outs.append(xt.transpose(1, 2).reshape(B, E, H, W))
        c2 = c[:, :n2].transpose(1, 2).reshape(B, E, 2 * H, 2 * W)
        c3 = c[:, n2:n2 + n3].transpose(1, 2).reshape(B, E, H, W)
        c4 = c[:, n2 + n3:].transpose(1, 2).reshape(B, E, H // 2, W // 2)
        x1, x2, x3, x4 = outs
        f1 = self.norm1(self.up(c2) + c1 + resize(x1, (4 * H, 4 * W)))
        return [f1, self.norm2(c2 + resize(x2, (2 * H, 2 * W))),
                self.norm3(c3 + x3), self.norm4(c4 + resize(x4, (H // 2,
                                                                  W // 2)))]


class SegformerHead(nn.Module):
    def __init__(self, cin, classes, channels, dropout):
        super().__init__()
        self.convs = nn.ModuleList(ConvNormAct(cin, channels, 1, norm="bn")
                                   for _ in range(4))
        self.fusion_conv = ConvNormAct(4 * channels, channels, 1, norm="bn")
        self.dropout = KeyedDropout(dropout)
        self.conv_seg = Conv2d(channels, classes, 1)

    def forward(self, feats):
        size = feats[0].shape[-2:]
        outs = [resize(conv(f), size) for conv, f in zip(self.convs, feats)]
        return self.conv_seg(self.dropout(self.fusion_conv(torch.cat(outs,
                                                                     1))))


def ohem_cross_entropy(logits, labels, ignore_index=255, thresh=0.7,
                       min_kept=100_000):
    """PIDNet-style OHEM cross entropy, one threshold per sample, the mean
    of the samples' means: keep a sample's valid pixels whose true-class
    probability is below max(thresh, its k-th smallest, k = min(min_kept,
    n_valid - 1)); a sample with no valid pixel counts 0."""
    B, C = logits.shape[0], logits.shape[-1]
    logits = logits.reshape(B, -1, C).float()
    labels = labels.reshape(B, -1).long()
    valid = labels != ignore_index
    logp = torch.log_softmax(logits, -1).gather(
        2, torch.where(valid, labels, 0)[..., None])[..., 0]
    with torch.no_grad():
        prob = logp.exp()
        ordered = torch.where(valid, prob, torch.inf).sort(dim=1)[0]
        n_valid = valid.sum(1)
        k = (n_valid - 1).clamp(min=0, max=min_kept)
        th = ordered.gather(1, k[:, None])[:, 0].clamp(min=thresh)
        keep = valid & (prob < th[:, None])
    rows = torch.where(keep, -logp, 0.0).sum(1) / keep.sum(1).clamp(min=1)
    return torch.where(n_valid > 0, rows, 0.0).mean()


class Segmentor(nn.Module):
    """Backbone + SegFormer head; logits resized to the input, NHWC."""

    def __init__(self, model_cfg: dict):
        super().__init__()
        if model_cfg.get("head_type", "segformer") != "segformer":
            raise ValueError("the reference holds the SegFormer head only")
        self.backbone = Backbone(**model_cfg["backbone"])
        self.decode_head = SegformerHead(self.backbone.embed_dim,
                                         model_cfg["num_classes"],
                                         model_cfg["head_channels"],
                                         model_cfg.get("dropout_ratio", 0.1))

    def forward(self, img):
        """img (B, H, W, C_in) -> logits (B, H, W, classes)."""
        feats = self.backbone(img.permute(0, 3, 1, 2))
        return resize(self.decode_head(feats),
                      img.shape[1:3]).permute(0, 2, 3, 1)

    def loss(self, img, gt, ignore_index=255, thresh=0.7, min_kept=100_000):
        feats = self.backbone(img.permute(0, 3, 1, 2))
        logits = resize(self.decode_head(feats),
                        gt.shape[1:3]).permute(0, 2, 3, 1)
        return ohem_cross_entropy(logits, gt, ignore_index, thresh, min_kept)


NORM_TYPES = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, LayerNorm2d, _Body)


def build(model_cfg: dict, device="meta") -> Segmentor:
    """The reference segmentor on `device`, its tensors uninitialised."""
    with torch.device("meta"):
        model = Segmentor(model_cfg)
    return model if str(device) == "meta" else model.to_empty(device=device)
