"""Plain PyTorch reference of PEMP stage 1, stage 2 and their cascade.

Written from the published description (Jarvis73/PEMP,
``networks/pemp_stage1.py``, ``networks/pemp_stage2.py``,
``networks/backbones.py``, ``core/losses.py``), in float32 with TF32 off,
NCHW, with no hand-written kernel, no cache and no batching trick. It
imports nothing of the program: the benchmark makes the weights and the
inputs from the seed and hands the same to the program and to this file.
The modules carry the reference's ``state_dict`` keys, so one state dict
loads into both.

- Stage 1: dilated ResNet-50 (output stride 8, three stages), purifier
  (1x1 conv, DropBlock, 3x3 conv, DropBlock, ASPPV2 with BN and DropBlock
  before each branch), the meta-prototype module (soft assignment of the
  support pixels to 2p learned centers, adaptive prototypes, max over p
  of the cosine similarity times 20) and an align-corners upsample.
- Stage 2: RGB plus a prior through a ResNet whose communication modules
  pool each episode's prior-masked features, the ASPP purifier with
  channel dropout, and the same meta-prototype module.
- The cascade: stage 1's argmax at input size is stage 2's query prior.
- ``cedt``: cross entropy weighted by ``exp(-EDT(boundary)/sigma^2) + 1``
  over the total weight, the EDT exact (brute force, in row blocks).
- ``sgd_step``: global-norm clip, weight decay into the gradient,
  momentum (dampening 0, no Nesterov), the update.

``precision="fp8"`` is the control: every convolution of the backbones
and purifiers takes its input and weight rounded to float8 e4m3 with a
per-tensor scale, and its output's cotangent rounded to e5m2, the step
below the configuration's bf16. Everything after the encoders stays in
float32 either way.

DropBlock and channel dropout draw their uniforms from an explicit
generator, one ``torch.rand`` a module in forward order, so a generator
seeded as the program's draws the program's masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark import weights
from benchmark.traffic import sub_seed

RESNET50 = (3, 4, 6)
ASSIGN_EPS, COS_EPS = 1e-6, 1e-8
RESIDUAL_GAIN = 0.1
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def exact_f32() -> None:
    """float32 matrix products and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- the control's precision --------------------------------------------

def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale (its absolute
    maximum to the type's largest value), back in x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX[dtype] / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8In(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the cotangent passes."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: the identity; backward: the cotangent rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class Conv(nn.Conv2d):
    """``nn.Conv2d``; with ``fp8`` set (``set_precision``) its operands are
    rounded to float8 and its output's cotangent too."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        w = _Fp8In.apply(self.weight)
        y = self._conv_forward(_Fp8In.apply(x), w, self.bias)
        return _Fp8Grad.apply(y)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    if precision not in ("f32", "fp8"):
        raise ValueError(f"reference precision {precision!r} (f32 | fp8)")
    for m in model.modules():
        if isinstance(m, Conv):
            m.fp8 = precision == "fp8"
    return model


# --- dropout -------------------------------------------------------------

class DropBlock(nn.Module):
    """DropBlock2D: seeds with probability rate / block^2 per sample and
    pixel (shared by the channels), grown by a stride-1 max-pool (one row
    and column cropped for an even block), output times numel / kept."""

    def __init__(self, rate: float, block: int):
        super().__init__()
        self.rate, self.block = rate, block
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        n, _, h, w = x.shape
        u = torch.rand((n, h, w), generator=self.generator, device=x.device)
        seed = (u < self.rate / self.block ** 2).float()
        grown = F.max_pool2d(seed[:, None], self.block, 1,
                             self.block // 2)[:, 0]
        if self.block % 2 == 0:
            grown = grown[:, :-1, :-1]
        mask = 1.0 - grown
        scale = mask.numel() / mask.sum().clamp(min=1.0)
        return (x * (mask * scale)[:, None]).to(x.dtype)


class Dropout2d(nn.Module):
    """Channel dropout drawing from an explicit generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape[:2] + (1, 1), generator=self.generator,
                          device=x.device) >= self.rate
        return x / (1.0 - self.rate) * keep


def set_generator(model: nn.Module, generator) -> None:
    for m in model.modules():
        if isinstance(m, (DropBlock, Dropout2d)):
            m.generator = generator


# --- backbones -----------------------------------------------------------

class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        d = dilation
        self.conv1 = Conv(cin, planes, 1, stride=stride, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, padding=d, dilation=d,
                          bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            Conv(cin, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


# (planes, stride, dilation) of the three stages: output stride 8
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2))


class ResNet(nn.Module):
    """The three-stage dilated ResNet trunk (1024 channels out)."""

    def __init__(self, layers: Sequence[int] = RESNET50, cin: int = 3,
                 extra: int = 0, comm: bool = False):
        super().__init__()
        self.comm = comm
        self.conv1 = Conv(cin, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for si, ((planes, stride, dil), n) in enumerate(zip(STAGES, layers),
                                                        1):
            if comm:
                setattr(self, f"linear{si}", nn.Linear(2 * inplanes, extra))
            # the first block takes the stage's input (and the code of the
            # communication module) and has the projection shortcut
            blocks = [Bottleneck(inplanes + (extra if comm else 0), planes,
                                 stride, dil, downsample=True)]
            blocks += [Bottleneck(planes * 4, planes, 1, dil)
                       for _ in range(1, n)]
            setattr(self, f"layer{si}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.out_channels = inplanes

    def stem(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, 2, 1, ceil_mode=True)

    def forward(self, x):
        x = self.stem(x)
        for si in (1, 2, 3):
            x = getattr(self, f"layer{si}")(x)
        return x

    def forward_comm(self, x, prior, spq: int):
        """Stage 2's trunk: before each stage, the episode's masked mean
        and max of the features, averaged over its ``spq`` images, mapped
        to ``extra`` channels and broadcast to every pixel."""
        mask = F.max_pool2d(prior, 3, 2, 1)
        x = self.stem(x)
        for si, mstride in zip((1, 2, 3), (2, 1, 2)):
            mask = F.max_pool2d(mask, 3, mstride, 1)
            n, c, h, w = x.shape
            masked = (x * mask).flatten(2)
            mean = masked.mean(2).reshape(-1, spq, c).mean(1)
            mx = masked.amax(2).reshape(-1, spq, c).mean(1)
            code = getattr(self, f"linear{si}")(torch.cat([mean, mx], 1))
            code = code.repeat_interleave(spq, 0)[:, :, None, None]
            x = torch.cat([x, code.expand(-1, -1, h, w)], 1)
            x = getattr(self, f"layer{si}")(x)
        return x


class ASPPV2(nn.Module):
    """Stage 1's ASPP: BN and DropBlock before each branch's conv (a
    global-pool branch, a 1x1 and 3x3s at dilation 6, 12, 18), ReLU,
    then the 1x1 ``layer6`` over their concatenation."""

    def __init__(self, cin=256, mid=256, out=512, rate=0.1, block=4):
        super().__init__()
        for k, (ks, d) in enumerate([(1, 1), (1, 1), (3, 6), (3, 12),
                                     (3, 18)]):
            setattr(self, f"aspp_{k}", nn.Sequential(
                nn.BatchNorm2d(cin), DropBlock(rate, block),
                Conv(cin, mid, ks, padding=d if ks == 3 else 0, dilation=d),
                nn.ReLU()))
        self.layer6 = Conv(5 * mid, out, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        g = self.aspp_0(x.mean((2, 3), keepdim=True)).expand(-1, -1, h, w)
        return self.layer6(torch.cat(
            [g] + [getattr(self, f"aspp_{k}")(x) for k in (1, 2, 3, 4)], 1))


class ASPP(nn.Module):
    """Stage 2's ASPP: each branch conv, ReLU, channel dropout."""

    def __init__(self, cin=256, mid=256, out=512, rate=0.5):
        super().__init__()
        for k, (ks, d) in enumerate([(1, 1), (1, 1), (3, 6), (3, 12),
                                     (3, 18)]):
            setattr(self, f"aspp_{k}", nn.Sequential(
                Conv(cin, mid, ks, padding=d if ks == 3 else 0, dilation=d),
                nn.ReLU(), Dropout2d(rate)))
        self.layer6 = Conv(5 * mid, out, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        g = self.aspp_0(x.mean((2, 3), keepdim=True)).expand(-1, -1, h, w)
        return self.layer6(torch.cat(
            [g] + [getattr(self, f"aspp_{k}")(x) for k in (1, 2, 3, 4)], 1))


def purifier_v2(cin, out, rate, block):
    return nn.Sequential(Conv(cin, 256, 1), nn.ReLU(), DropBlock(rate, block),
                         Conv(256, 256, 3, padding=1), nn.ReLU(),
                         DropBlock(rate, block),
                         ASPPV2(256, 256, out, rate, block))


def purifier_v1(cin, out, rate):
    return nn.Sequential(Conv(cin, 256, 1), nn.ReLU(), Dropout2d(rate),
                         Conv(256, 256, 3, padding=1), nn.ReLU(),
                         Dropout2d(rate), ASPP(256, 256, out, rate))


# --- the meta-prototype module -------------------------------------------

def nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [N, C, H, W]: source index floor(dst * in / out),
    in integers."""
    big_h, big_w = x.shape[-2:]
    rows = torch.arange(hw[0], device=x.device) * big_h // hw[0]
    cols = torch.arange(hw[1], device=x.device) * big_w // hw[1]
    return x[..., rows[:, None], cols[None, :]]


def cosine(x, y):
    """x [..., n, c], y [..., k, c] -> [..., n, k]."""
    dot = torch.einsum("...nc,...kc->...nk", x, y)
    norm = x.norm(dim=-1)[..., :, None] * y.norm(dim=-1)[..., None, :]
    return dot / norm.clamp(min=COS_EPS)


def mpm(sup, qry, fg, bg, ctr, p: int, scalar: float):
    """sup [B,S,n,c], qry [B,Q,n,c], fg/bg [B,S,n], ctr [c, 2p] ->
    logits [B,Q,n,2] ([bg, fg])."""
    b, s, n, c = sup.shape
    dist = -((sup * sup).sum(-1, keepdim=True)
             - 2.0 * torch.einsum("bsnc,ck->bsnk", sup, ctr)
             + (ctr * ctr).sum(0))
    assign = torch.softmax(dist.reshape(b, s, n, 2, p), -1)
    assign = (assign * torch.stack([fg, bg], -1)[..., None]
              ).reshape(b, s, n, 2 * p)
    num = torch.einsum("bsnc,bsnk->bskc", sup, assign)
    proto = (num / (assign.sum(2)[..., None] + ASSIGN_EPS)).mean(1)
    fg_sim = cosine(qry, proto[:, None, :p]) * scalar       # [B,Q,n,p]
    bg_sim = cosine(qry, proto[:, None, p:]) * scalar
    return torch.stack([bg_sim.amax(-1), fg_sim.amax(-1)], -1)


def upsample(logits: torch.Tensor, hw) -> torch.Tensor:
    """[B,Q,h,w,2] -> [B,Q,*hw,2], bilinear with aligned corners."""
    b, q, h, w, _ = logits.shape
    x = logits.reshape(b * q, h, w, 2).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)
    return x.permute(0, 2, 3, 1).reshape(b, q, hw[0], hw[1], 2)


class _Stage(nn.Module):
    protos: int
    scalar: float

    def head(self, fts, sup_mask, q: int, out_hw):
        """Encoder features [B*(S+Q), c, h, w] -> logits [B,Q,*,2]."""
        b, s = sup_mask.shape[:2]
        c, h, w = fts.shape[1:]
        fts = fts.to(self.ctr.dtype).permute(0, 2, 3, 1).reshape(
            b, s + q, h * w, c)
        m = nearest(sup_mask.reshape(b * s, *sup_mask.shape[2:])
                    .permute(0, 3, 1, 2), (h, w))
        m = m.permute(0, 2, 3, 1).reshape(b, s, h * w, 2)
        logits = mpm(fts[:, :s], fts[:, s:], m[..., 0], m[..., 1], self.ctr,
                     self.protos, self.scalar).reshape(b, q, h, w, 2)
        return logits if out_hw is None else upsample(logits, out_hw)


class Stage1(_Stage):
    def __init__(self, layers=RESNET50, out_channels=512, protos=3,
                 drop_rate=0.1, block_size=4, dist_scalar=20.0):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.backbone = ResNet(layers)
        self.encoder.purifier = purifier_v2(1024, out_channels, drop_rate,
                                            block_size)
        self.ctr = nn.Parameter(torch.zeros(out_channels, 2 * protos))
        self.protos, self.scalar = protos, dist_scalar

    def features(self, sup_img, sup_mask, qry_img, qry_prior=None):
        """The encoder's features [B*(S+Q), c, h, w] of the episodes'
        support and query images."""
        b, s, big_h, big_w, _ = sup_img.shape
        x = torch.cat([sup_img, qry_img], 1).reshape(-1, big_h, big_w, 3)
        x = x.permute(0, 3, 1, 2).contiguous()
        return self.encoder.purifier(self.encoder.backbone(x))

    def forward(self, sup_img, sup_mask, qry_img, out_hw="input"):
        """sup_img [B,S,H,W,3], sup_mask [B,S,H,W,2] (fg, bg), qry_img
        [B,Q,H,W,3] -> logits [B,Q,*out_hw,2]; None: feature size."""
        fts = self.features(sup_img, sup_mask, qry_img)
        return self.head(fts, sup_mask, qry_img.shape[1],
                         sup_img.shape[2:4] if out_hw == "input" else out_hw)

    def stages(self, sup_img, sup_mask, qry_img):
        yield self, (sup_img, sup_mask, qry_img)

    def trainable(self) -> Dict[str, nn.Parameter]:
        """Every parameter but the trunk's BN affines."""
        frozen = {f"encoder.backbone.{n}" for n, m in
                  self.encoder.backbone.named_modules()
                  if isinstance(m, nn.BatchNorm2d)}
        return {n: p for n, p in self.named_parameters()
                if n.rsplit(".", 1)[0] not in frozen}


class Stage2(_Stage):
    def __init__(self, layers=RESNET50, out_channels=512, protos=3,
                 drop_rate=0.5, dist_scalar=20.0):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.backbone = ResNet(layers, cin=4, extra=2, comm=True)
        self.encoder.purifier = purifier_v1(1024, out_channels, drop_rate)
        self.ctr = nn.Parameter(torch.zeros(out_channels, 2 * protos))
        self.protos, self.scalar = protos, dist_scalar

    def features(self, sup_img, sup_mask, qry_img, qry_prior):
        """The encoder's features of RGB plus the prior (the support's fg
        mask, the query's ``qry_prior`` [B,Q,H,W])."""
        b, s, big_h, big_w, _ = sup_img.shape
        prior = torch.cat([sup_mask[..., :1], qry_prior[..., None]], 1)
        x = torch.cat([torch.cat([sup_img, qry_img], 1), prior], -1)
        x = x.reshape(-1, big_h, big_w, 4).permute(0, 3, 1, 2)
        prior = prior.reshape(-1, big_h, big_w, 1).permute(0, 3, 1, 2)
        fts = self.encoder.backbone.forward_comm(
            x.contiguous(), prior.contiguous(), s + qry_img.shape[1])
        return self.encoder.purifier(fts)

    def forward(self, sup_img, sup_mask, qry_img, qry_prior, out_hw="input"):
        fts = self.features(sup_img, sup_mask, qry_img, qry_prior)
        return self.head(fts, sup_mask, qry_img.shape[1],
                         sup_img.shape[2:4] if out_hw == "input" else out_hw)


class Cascade(nn.Module):
    """Stage 1's argmax at input size -> stage 2's query prior."""

    def __init__(self, stage1: Stage1, stage2: Stage2):
        super().__init__()
        self.stage1, self.stage2 = stage1, stage2

    def prior(self, sup_img, sup_mask, qry_img) -> torch.Tensor:
        with torch.no_grad():
            return self.stage1(sup_img, sup_mask, qry_img).argmax(-1).float()

    def forward(self, sup_img, sup_mask, qry_img, out_hw="input"):
        prior = self.prior(sup_img, sup_mask, qry_img)
        return self.stage2(sup_img, sup_mask, qry_img, prior, out_hw)

    def stages(self, sup_img, sup_mask, qry_img):
        """(stage, its ``features`` arguments) in order, for calibration."""
        yield self.stage1, (sup_img, sup_mask, qry_img)
        yield self.stage2, (sup_img, sup_mask, qry_img,
                            self.prior(sup_img, sup_mask, qry_img))


def build(cfg: Dict, device=None, precision: str = "f32") -> nn.Module:
    """The reference model of a configuration file's ``model`` section
    (on ``device``; None keeps the default device)."""
    m = cfg["model"]
    layers = tuple(m.get("resnet_layers", RESNET50))

    def stage1():
        return Stage1(layers, m["out_channels"], m["protos"], m["drop_rate"],
                      m["block_size"], m["dist_scalar"])
    if m["family"] == "pemp_stage1":
        model = stage1()
    elif m["family"] == "pemp_cascade":
        model = Cascade(stage1(), Stage2(layers, m["out_channels"],
                                         m["protos2"], m["drop_rate2"],
                                         m["dist_scalar"]))
    else:
        raise ValueError(f"no reference for family {m['family']!r}")
    if device is not None:
        model = model.to(device)
    return set_precision(model, precision)


# --- loss, update, metrics -------------------------------------------------

def edt(feature: torch.Tensor, rows: int = 16) -> torch.Tensor:
    """Exact Euclidean distance transform of a boolean [B, H, W] map: the
    distance to the nearest True pixel, 1e6 where there is none. Brute
    force over the map's True pixels' rows and columns, in blocks."""
    b, h, w = feature.shape
    big = 1.0e12
    src = torch.where(feature, 0.0, big).float()
    i = torch.arange(h, device=feature.device, dtype=torch.float32)
    j = torch.arange(w, device=feature.device, dtype=torch.float32)
    col = torch.empty_like(src)
    for r in range(0, h, rows):         # along H: min_k (i-k)^2 + src[k]
        d = (i[r:r + rows, None] - i[None, :]) ** 2          # [rows, H]
        col[:, r:r + rows] = (d[None, :, :, None]
                              + src[:, None]).amin(2)
    out = torch.empty_like(src)
    for r in range(0, h, rows):         # along W
        d = (j[:, None] - j[None, :]) ** 2                   # [W, W]
        out[:, r:r + rows] = (col[:, r:r + rows, :, None]
                              + d[None, None]).amin(2)
    return torch.sqrt(out.clamp(max=big))


def boundary(labels: torch.Tensor) -> torch.Tensor:
    """The foreground's inner and outer boundary: pixels whose 3x3
    neighbourhood holds both classes' pixels of a fg/not-fg map."""
    m = (labels == 1).float()[:, None]
    s = F.conv2d(F.pad(m, (1, 1, 1, 1)), torch.ones(1, 1, 3, 3,
                                                    device=m.device))[:, 0]
    m = m[:, 0]
    return ((s.clamp(0, 1) - m) + (m - (s - 8).clamp(0, 1))).round() >= 1


def cedt(logits: torch.Tensor, labels: torch.Tensor, sigma: float = 5.0):
    """logits [N,H,W,2], labels [N,H,W] -> the weighted mean CE."""
    logz = torch.logsumexp(logits, -1)
    valid = labels != 255
    ll = torch.gather(logits, -1, torch.where(valid, labels, 0).long()
                      [..., None])[..., 0]
    pix = torch.where(valid, logz - ll, torch.zeros_like(logz))
    weight = torch.exp(-edt(boundary(labels)) / sigma ** 2) + 1.0
    return (pix * weight).sum() / weight.sum()


def episode_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [Q,H,W,2], labels [Q,H,W] -> the episode's CE: each query's
    mean over its non-ignored pixels, averaged over the queries."""
    logz = torch.logsumexp(logits, -1)
    valid = labels != 255
    ll = torch.gather(logits, -1, torch.where(valid, labels, 0).long()
                      [..., None])[..., 0]
    pix = torch.where(valid, logz - ll, torch.zeros_like(logz))
    return (pix.flatten(1).sum(1) / valid.flatten(1).sum(1).clamp(min=1)
            ).mean()


def counts(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[2, 3] int64: rows (bg, fg), columns (tp, fp, fn), summed over the
    leading axes; label 255 is ignored."""
    valid = ref != 255
    out = []
    for cls in (0, 1):
        p, r = (pred == cls) & valid, (ref == cls) & valid
        out.append(torch.stack([(p & r).sum(), (p & ~r).sum(),
                                (~p & r).sum()]))
    return torch.stack(out).long()


class SGD:
    """SGD as the configuration states it: clip the global gradient norm
    to ``clip`` (off at 0), add ``wd`` * w, momentum ``mu``, step ``lr``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, mu, wd, clip):
        self.params, self.lr, self.mu, self.wd, self.clip = (params, lr, mu,
                                                             wd, clip)
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip > 0:
            total = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            coef = (self.clip / (total + 1e-6)).clamp(max=1.0)
            grads = {k: g * coef for k, g in grads.items()}
        for k, p in self.params.items():
            d = grads[k] + self.wd * p
            buf = self.buf.get(k)
            self.buf[k] = (d.clone() if buf is None
                           else buf.mul_(self.mu).add_(d))
            p.sub_(self.lr * self.buf[k])


def optimizer(cfg: Dict, params: Dict[str, torch.Tensor]) -> SGD:
    t = cfg["train"]
    if t["opt"] != "sgd" or t["nesterov"]:
        raise ValueError(f"the reference's optimizer is plain SGD, not "
                         f"{t['opt']!r} (nesterov {t['nesterov']})")
    return SGD(params, t["lr"], t["momentum"], t["weight_decay"],
               t["grad_clip"])


def train_step(model: Stage1, opt: SGD, batch: Dict[str, torch.Tensor],
               cfg: Dict) -> torch.Tensor:
    """One training step on a batch (sup_rgb, sup_mask, qry_rgb, qry_msk):
    returns the loss (detached)."""
    t = cfg["train"]
    if t["loss"] != "cedt":
        raise ValueError(f"the reference's loss is cedt, not {t['loss']!r}")
    logits = model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"])
    labels = batch["qry_msk"].long()
    loss = cedt(logits.reshape(-1, *logits.shape[-3:]),
                labels.reshape(-1, *labels.shape[-2:]), t["sigma"])
    names = list(opt.params)
    grads = torch.autograd.grad(loss, [opt.params[n] for n in names])
    opt.step(dict(zip(names, grads)))
    return loss.detach()


def logits(model: nn.Module, batch: Dict[str, torch.Tensor]):
    """The forward at feature resolution: [B,Q,h,w,2]."""
    return model(batch["sup_rgb"], batch["sup_mask"], batch["qry_rgb"],
                 out_hw=None)


def answers(model: nn.Module, batch: Dict[str, torch.Tensor],
            gts: Sequence[torch.Tensor]) -> List[Tuple[np.ndarray, float]]:
    """Each episode's (counts [2, 3], cross entropy) against its GT
    [Q,H',W'], the logits upsampled to the GT's size."""
    out = logits(model, batch)
    res = []
    for j, gt in enumerate(gts):
        up = upsample(out[j:j + 1], gt.shape[-2:])[0]
        res.append((counts(up.argmax(-1), gt).cpu().numpy(),
                    float(episode_ce(up, gt))))
    return res


def state_keys(model: nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


# --- the seeded weights --------------------------------------------------
#
# No pretrained file is in the repository, so both the program and the
# reference load a state dict drawn from ``--seed`` (``weights.draw``),
# with the last batch norm of each residual branch (``bn3``) at
# ``RESIDUAL_GAIN``: the small-gain start of a residual branch (Goyal et
# al. 2017, "Accurate, Large Minibatch SGD"; Zhang et al. 2019, Fixup).
# At gain 1 a drawn, batch-normed ResNet-50 is chaotic: bf16 rounding
# moved its features by 36 % of their norm against float32 on the CPU at
# 65^2, fp8 by 86 %, so no output could tell the two precisions apart; at
# 0.1, by 3-4 % and 27-43 %.
#
# ``calibrate`` then gives the drawn network what a trained one has and a
# drawn one lacks, from calibration episodes of the same seed, on this
# reference in float32: each batch norm's running statistics (its batch
# statistics over the calibration images), and prototype centres inside
# each class's support features: the class's mean feature plus a seeded
# offset of 1 / (2 sqrt(2) r), r the features' RMS distance from that
# mean, so that the soft assignment's logits differ by about 1 and every
# centre takes a share of the pixels. A drawn network's features lie far
# apart (|f - c|^2 of hundreds): centres drawn U[0, 1), or picked among
# the features, make the assignment hard, a prototype's direction then
# follows rounding, and the model's output is chaotic under any
# precision, so that no comparison could tell float32 from a lower one.

def _norm_gain(module: str) -> float:
    return RESIDUAL_GAIN if module.endswith(".bn3") else 1.0


def seeded_state(cfg: Dict, seed: int, episodes: Dict, device
                 ) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``: drawn, then calibrated
    on ``episodes``."""
    with torch.device("meta"):
        layout = state_keys(build(cfg))
    state = weights.draw(layout, sub_seed(seed, 0), device,
                         norm_gain=_norm_gain, uniform={"ctr": (0.0, 1.0)})
    return calibrate(cfg, state, episodes, sub_seed(seed, 7), device)


@torch.no_grad()
def calibrate(cfg: Dict, state: Dict[str, torch.Tensor], episodes: Dict,
              seed: int, device) -> Dict[str, torch.Tensor]:
    """``state`` with its batch norms' running statistics and its
    prototype centres taken from ``episodes``, stage by stage (the
    cascade's stage 2 on stage 1's calibrated prior)."""
    exact_f32()
    model = build(cfg, device)
    model.load_state_dict(state)
    model.eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    x = {k: episodes[k].float() for k in ("sup_rgb", "sup_mask", "qry_rgb")}
    sup_mask = x["sup_mask"]
    b, s = sup_mask.shape[:2]
    for stage, args in model.stages(x["sup_rgb"], sup_mask, x["qry_rgb"]):
        bns = [m for m in stage.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in bns:           # one batch's statistics, unbiased variance
            m.reset_running_stats()
            m.momentum = None
            m.train()
        stage.features(*args)
        for m in bns:
            m.momentum = 0.1
            m.eval()
        fts = stage.features(*args)
        c, h, w = fts.shape[1:]
        sup = fts.reshape(b, -1, c, h, w)[:, :s].permute(0, 1, 3, 4, 2)
        sup = sup.reshape(-1, c)
        m = nearest(sup_mask.reshape(b * s, *sup_mask.shape[2:])
                    .permute(0, 3, 1, 2), (h, w))
        m = m.permute(0, 2, 3, 1).reshape(-1, 2)
        cols = []
        for cls in (0, 1):                          # fg, then bg
            f = sup[m[:, cls] > 0.5]
            mu = f.mean(0)
            r = (f - mu).square().sum(1).mean().sqrt()
            z = torch.randn((stage.protos, c), generator=gen, device=device)
            cols.append(mu + z / (2 * math.sqrt(2) * r))
        stage.ctr.copy_(torch.cat(cols).T)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
