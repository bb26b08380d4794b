"""SwiftNet on a ResNet of the family its configuration names, and
CSP-R50, as BlockCopy serves them, in plain PyTorch.

A frame executes the blocks of a grid.  Every layer that reads
neighbouring pixels (a convolution or pool with padding, a dense part)
reads a *site*: the layer's input where this frame executed the block,
and, where it did not, the value that site held when that block last
executed.  The models here compute every layer over the whole frame and
keep that composite at each site (``Frame.site``); what a skipped block
computes is never read.  Two layers the served models run per block with
no halo run per block here too: SwiftNet decoder's bilinear upsampling
and CSP neck's transposed convolutions.  CSP's GroupNorm takes its
statistics over the executed blocks.  On a frame that executes every
block this is the dense model, up to those per-block layers.

Tensors are NCHW.  Parameters are nested dicts of tensors: conv weights
OIHW, inference BatchNorm folded to (scale, bias).  ``spec_*`` give each
leaf's shape and the law its random value is drawn from
(``harness/weights.py`` draws them on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _round(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return t.to(torch.bfloat16).float()
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Rounded(torch.autograd.Function):
    """Rounds the operand going forward and its gradient going back, so
    that a backward pass is computed at the same precision."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return _round(t, kind)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.kind), None


def rounder(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of every convolution's operands, forward and back:
    ``fp32`` none; ``bf16`` to bfloat16; ``fp8`` to float8 e4m3 with one
    scale a tensor (its largest magnitude onto 448).  Products and sums
    stay fp32."""
    if kind == "fp32":
        return lambda t: t
    if kind not in ("bf16", "fp8"):
        raise ValueError(f"unknown precision {kind!r}")
    return lambda t: _Rounded.apply(t, kind)


# ---------------------------------------------------------------------------
# one frame's execution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Frame:
    """The grid a frame executes, the sites carried across frames and the
    operand rounding.  ``grid`` (gh, gw) bool; ``sites`` is shared by the
    frames of a clip.  ``macs``, where given, tallies each layer's
    multiply-accumulates over the whole frame, by name, with whether the
    layer runs over the executed blocks only (``work.macs``)."""

    grid: torch.Tensor
    sites: Dict[str, torch.Tensor]
    prec: Callable = rounder("fp32")
    macs: Optional[Dict[str, tuple]] = None

    def mask(self, h: int, w: int) -> torch.Tensor:
        gh, gw = self.grid.shape
        m = self.grid.repeat_interleave(h // gh, 0)
        return m.repeat_interleave(w // gw, 1)[None, None]

    def site(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` where this frame executed, the site's carried value
        elsewhere; the composite is carried on."""
        if name in self.sites:
            x = torch.where(self.mask(x.shape[2], x.shape[3]), x,
                            self.sites[name])
        self.sites[name] = x
        return x

    def per_block(self, x: torch.Tensor, fn) -> torch.Tensor:
        """``fn`` over each block on its own: (K, C, b, b) -> (K, C', b',
        b')."""
        gh, gw = self.grid.shape
        n, c, h, w = x.shape
        b = h // gh
        blocks = x.reshape(n, c, gh, b, gw, b).permute(0, 2, 4, 1, 3, 5) \
            .reshape(n * gh * gw, c, b, b)
        y = fn(blocks)
        c2, b2 = y.shape[1], y.shape[2]
        return y.reshape(n, gh, gw, c2, b2, b2).permute(0, 3, 1, 4, 2, 5) \
            .reshape(n, c2, gh * b2, gw * b2)

    def tally(self, name: str, count: float, blocked: bool) -> None:
        if self.macs is not None:
            self.macs[name] = (float(count), blocked)


def conv(fr: Frame, name: str, x, w, b=None, stride=1, pad=0, dil=1,
         blocked=True, groups=1):
    """A convolution; with padding over blocks its input is a site."""
    if pad > 0 and blocked:
        x = fr.site(name, x)
    y = F.conv2d(fr.prec(x), fr.prec(w), None, stride, pad, dil, groups)
    fr.tally(name, y.numel() * w.shape[1] * w.shape[2] * w.shape[3],
             blocked)
    return y if b is None else y + b.view(1, -1, 1, 1)


def bn(x, p):
    return x * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


relu = F.relu


# ---------------------------------------------------------------------------
# ResNets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResNet:
    """One of the ResNets the served SwiftNet lists (torchvision's
    definitions): blocks a stage, basic or bottleneck blocks, and the
    bottleneck's 3x3 groups and base width."""
    layers: tuple
    bottleneck: bool
    groups: int = 1
    base_width: int = 64

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1

    def width(self, planes: int) -> int:
        """A bottleneck's inner width, its grouped 3x3's channels."""
        return int(planes * self.base_width / 64.0) * self.groups

    @property
    def features(self) -> tuple:
        """The four stages' output channels."""
        return tuple(c * self.expansion for c in PLANES)


PLANES = (64, 128, 256, 512)
RESNETS = {
    "resnet18": ResNet((2, 2, 2, 2), False),
    "resnet34": ResNet((3, 4, 6, 3), False),
    "resnet50": ResNet((3, 4, 6, 3), True),
    "resnet101": ResNet((3, 4, 23, 3), True),
    "resnet152": ResNet((3, 8, 36, 3), True),
    "resnext50_32x4d": ResNet((3, 4, 6, 3), True, groups=32, base_width=4),
    "resnext101_32x8d": ResNet((3, 4, 23, 3), True, groups=32,
                               base_width=8),
    "wide_resnet50_2": ResNet((3, 4, 6, 3), True, base_width=128),
    "wide_resnet101_2": ResNet((3, 4, 23, 3), True, base_width=128),
}


def stem(fr: Frame, p, x):
    """7x7 s2 conv, BN, ReLU, 3x3 s2 max pool (its input a site: a ReLU's
    output, so zeros past the image pad it as -inf would)."""
    y = relu(bn(conv(fr, "stem.conv", x, p["conv1"]["w"], stride=2, pad=3),
                p["bn1"]))
    return F.max_pool2d(fr.site("stem.pool", y), 3, 2, 1)


def _identity(fr: Frame, name: str, x, p, stride: int):
    """The block's input, or its strided 1x1 projection."""
    if "downsample" not in p:
        return x
    return bn(conv(fr, f"{name}.ds", x, p["downsample"]["conv"]["w"],
                   stride=stride), p["downsample"]["bn"])


def basic(fr: Frame, name: str, x, p, stride: int, dil: int):
    """3x3 (stride, dilation), 3x3 (dilation), with the identity or a
    strided 1x1 projection."""
    idt = _identity(fr, name, x, p, stride)
    h = relu(bn(conv(fr, f"{name}.conv1", x, p["conv1"]["w"], stride=stride,
                     pad=dil, dil=dil), p["bn1"]))
    h = bn(conv(fr, f"{name}.conv2", h, p["conv2"]["w"], pad=dil, dil=dil),
           p["bn2"])
    return relu(h + idt)


def bottleneck(fr: Frame, name: str, x, p, stride: int, dil: int):
    """1x1, 3x3 (stride, dilation, the groups its weight implies), 1x1,
    with the identity or a strided 1x1 projection."""
    idt = _identity(fr, name, x, p, stride)
    h = relu(bn(conv(fr, f"{name}.conv1", x, p["conv1"]["w"]), p["bn1"]))
    w2 = p["conv2"]["w"]
    h = relu(bn(conv(fr, f"{name}.conv2", h, w2, stride=stride, pad=dil,
                     dil=dil, groups=h.shape[1] // w2.shape[1]), p["bn2"]))
    h = bn(conv(fr, f"{name}.conv3", h, p["conv3"]["w"]), p["bn3"])
    return relu(h + idt)


def resnet(fr: Frame, p, x, name: str, strides,
           dilations) -> List[torch.Tensor]:
    """The four stages' outputs of ``RESNETS[name]``."""
    block = bottleneck if RESNETS[name].bottleneck else basic
    x = stem(fr, p, x)
    feats = []
    for s in range(4):
        for i, bp in enumerate(p[f"layer{s + 1}"]):
            x = block(fr, f"layer{s + 1}.{i}", x, bp,
                      strides[s] if i == 0 else 1, dilations[s])
        feats.append(x)
    return feats


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter: its shape, and its value ``mean + std * z`` with
    ``z`` standard normal; ``f32`` leaves stay float32 whatever the
    served dtype."""
    shape: tuple
    mean: float = 0.0
    std: float = 0.0
    f32: bool = False


def _conv_leaf(cout, cin, k):
    return {"w": Leaf((cout, cin, k, k), std=math.sqrt(2.0 / (k * k * cout)))}


def _bn_leaf(c, scale=1.0):
    """Folded BN drawn around ``scale``, so every affine is exercised."""
    return {"scale": Leaf((c,), scale, 0.1 * scale), "bias": Leaf((c,), 0.0,
                                                                  0.1)}


def spec_resnet(name: str, strides) -> Dict:
    """``RESNETS[name]`` (torchvision / mmdet v1.5 layout: stride on the
    3x3).  The last BN of each residual branch (a bottleneck's ``bn3``, a
    basic block's ``bn2``) is drawn around 0.25, so that many residual sums
    keep the activations' scale."""
    net = RESNETS[name]
    p: Dict = {"conv1": _conv_leaf(64, 3, 7), "bn1": _bn_leaf(64)}
    cin = 64
    for s, (planes, blocks) in enumerate(zip(PLANES, net.layers)):
        cout = planes * net.expansion
        stage = []
        for i in range(blocks):
            stride = strides[s] if i == 0 else 1
            if net.bottleneck:
                w = net.width(planes)
                bp = {"conv1": _conv_leaf(w, cin, 1), "bn1": _bn_leaf(w),
                      "conv2": _conv_leaf(w, w // net.groups, 3),
                      "bn2": _bn_leaf(w),
                      "conv3": _conv_leaf(cout, w, 1),
                      "bn3": _bn_leaf(cout, 0.25)}
            else:
                bp = {"conv1": _conv_leaf(planes, cin, 3),
                      "bn1": _bn_leaf(planes),
                      "conv2": _conv_leaf(planes, planes, 3),
                      "bn2": _bn_leaf(planes, 0.25)}
            if stride != 1 or cin != cout:
                bp["downsample"] = {"conv": _conv_leaf(cout, cin, 1),
                                    "bn": _bn_leaf(cout)}
            stage.append(bp)
            cin = cout
        p[f"layer{s + 1}"] = stage
    return p


# ---------------------------------------------------------------------------
# SwiftNet (semantic segmentation, output stride 4)
# ---------------------------------------------------------------------------


def _bnrc_leaf(cin, cout, k, bias=False):
    p = {"conv": _conv_leaf(cout, cin, k), "bn": _bn_leaf(cin)}
    if bias:
        p["conv"]["b"] = Leaf((cout,), 0.0, 0.1)
    return p


def spec_swiftnet(cfg: Dict) -> Dict:
    nf, levels = cfg["num_features"], cfg["spp_levels"]
    lvl = nf // levels
    feats = RESNETS[cfg["backbone"]].features
    return {
        "backbone": spec_resnet(cfg["backbone"], (1, 2, 2, 2)),
        "spp": {"bn": _bnrc_leaf(feats[3], nf, 1),
                "levels": [_bnrc_leaf(nf, lvl, 1) for _ in range(levels)],
                "fuse": _bnrc_leaf(nf + levels * lvl, nf, 1)},
        "ups": [{"bottleneck": _bnrc_leaf(skip, nf, 1),
                 "blend": _bnrc_leaf(nf, nf, 3)}
                for skip in (feats[2], feats[1], feats[0])],
        "logits": _bnrc_leaf(nf, cfg["num_classes"], 1, bias=True),
    }


def bnrc(fr: Frame, name: str, x, p, blocked=True):
    """BN, ReLU, conv (padding (k-1)/2)."""
    w = p["conv"]["w"]
    return conv(fr, name, relu(bn(x, p["bn"])), w, p["conv"].get("b"),
                pad=(w.shape[2] - 1) // 2, blocked=blocked)


def spp(fr: Frame, p, x, cfg: Dict):
    """Spatial pyramid pooling over the whole frame."""
    h, w = x.shape[2], x.shape[3]
    x = bnrc(fr, "spp.bn", x, p["bn"], blocked=False)
    levels = [x]
    for i, g in enumerate(cfg["spp_grids"][: cfg["spp_levels"]]):
        pooled = F.adaptive_avg_pool2d(x, (g, max(1, round(w / h * g))))
        lvl = bnrc(fr, f"spp.level{i}", pooled, p["levels"][i],
                   blocked=False)
        levels.append(F.interpolate(lvl, (h, w), mode="bilinear",
                                    align_corners=False))
    return bnrc(fr, "spp.fuse", torch.cat(levels, 1), p["fuse"],
                blocked=False)


def swiftnet(fr: Frame, p, x, cfg: Dict):
    """(1, 3, H, W) -> (1, classes, H/4, W/4) logits, carried at the
    ``out`` site."""
    f = resnet(fr, p["backbone"], x, cfg["backbone"], (1, 2, 2, 2),
               (1, 1, 1, 1))
    out = spp(fr, p["spp"], fr.site("spp", f[3]), cfg)
    up = lambda t: F.interpolate(t, (t.shape[2] * 2, t.shape[3] * 2),
                                 mode="bilinear", align_corners=False)
    for i, skip in enumerate((f[2], f[1], f[0])):
        q = p["ups"][i]
        skip = bnrc(fr, f"up{i}.bottleneck", skip, q["bottleneck"])
        out = bnrc(fr, f"up{i}.blend", fr.per_block(out, up) + skip,
                   q["blend"])
    return fr.site("out", bnrc(fr, "logits", out, p["logits"]))


# ---------------------------------------------------------------------------
# CSP (pedestrian detection, maps at stride 4)
# ---------------------------------------------------------------------------


def spec_csp(cfg: Dict) -> Dict:
    """mmdet's CSP-R50 with the configuration's neck and head.  The neck's
    transposed convs drawn with xavier's variance, the head's convs
    N(0, 0.01) as mmdet's init, the center map's bias 0."""
    out, feat = cfg["neck_out"], cfg["head_feat"]

    def conv_t(cin):
        std = math.sqrt(1.0 / (16 * (cin + out) / 2))
        return {"w": Leaf((cin, out, 4, 4), std=std), "b": Leaf((out,))}

    neck = {"p3": conv_t(512), "p4": conv_t(1024), "p5": conv_t(2048)}
    for k in ("p3", "p4", "p5"):
        neck[f"{k}_l2"] = Leaf((out,), cfg["l2norm_scale"])
    head: Dict = {}
    for branch in ("cls", "reg", "offset"):
        head[f"{branch}_convs"] = [{
            "conv": {"w": Leaf((feat, 3 * out, 3, 3), std=0.01)},
            "gn": {"gamma": Leaf((feat,), 1.0, f32=True),
                   "beta": Leaf((feat,), f32=True)}}]
    for key, c in (("csp_cls", cfg["num_classes"] - 1), ("csp_reg", 1),
                   ("csp_offset", 2)):
        head[key] = {"w": Leaf((c, feat, 3, 3), std=0.01), "b": Leaf((c,))}
    head["reg_scale"] = Leaf((), 1.0, f32=True)
    head["offset_scale"] = Leaf((), 1.0, f32=True)
    return {"backbone": spec_resnet("resnet50", tuple(cfg["strides"])),
            "neck": neck, "head": head}


def group_norm_executed(fr: Frame, x, groups, gamma, beta, eps=1e-5):
    """GroupNorm whose statistics are those of the executed blocks."""
    n, c, h, w = x.shape
    m = fr.mask(h, w).float()
    xg = x.reshape(n, groups, c // groups, h, w)
    cnt = m.sum() * (c // groups)
    mean = (xg * m[:, None]).sum(dim=(2, 3, 4), keepdim=True) / cnt
    var = (((xg - mean) ** 2) * m[:, None]).sum(dim=(2, 3, 4),
                                                keepdim=True) / cnt
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    return y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)


def csp(fr: Frame, p, x, cfg: Dict):
    """(1, 3, H, W) -> the (cls, reg, offset) maps at stride 4, each
    carried at its own site."""
    f = resnet(fr, p["backbone"], x, "resnet50", tuple(cfg["strides"]),
               tuple(cfg["dilations"]))
    outs = []
    for key, feat, stride, pad in (("p3", f[1], 2, 1), ("p4", f[2], 4, 0),
                                   ("p5", f[3], 4, 0)):
        q = p["neck"][key]
        y = fr.per_block(feat, lambda t: F.conv_transpose2d(
            fr.prec(t), fr.prec(q["w"]), q["b"], stride, pad))
        fr.tally(f"neck.{key}", feat.numel() * q["w"].shape[1] * 16, True)
        norm = torch.sqrt((y * y).sum(1, keepdim=True)) + 1e-10
        outs.append(y / norm * p["neck"][f"{key}_l2"].view(1, -1, 1, 1))
    x = torch.cat(outs, 1)
    head = p["head"]
    branches = ("cls", "reg", "offset")
    w_cat = torch.cat([head[f"{b}_convs"][0]["conv"]["w"] for b in branches])
    feat_all = conv(fr, "head.branch0", x, w_cat, pad=1)
    c = cfg["head_feat"]
    maps = []
    for j, (branch, key) in enumerate(zip(branches, ("csp_cls", "csp_reg",
                                                     "csp_offset"))):
        gn = head[f"{branch}_convs"][0]["gn"]
        feat = relu(group_norm_executed(fr, feat_all[:, j * c:(j + 1) * c],
                                        cfg["gn_groups"], gn["gamma"],
                                        gn["beta"]))
        out = conv(fr, f"head.{key}", feat, head[key]["w"], head[key]["b"],
                   pad=1)
        maps.append(fr.site(f"head.{key}.out", out))
    return (maps[0], maps[1] * head["reg_scale"],
            maps[2] * head["offset_scale"])
