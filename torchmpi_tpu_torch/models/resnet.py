"""ResNet (v1.5) in functional PyTorch.

Counterpart of ``torchmpi_tpu/models/resnet.py``: the same ``Config``, the
same parameter and BN-state trees (the JAX keys: ``stem_conv``,
``stem_bn``, ``blocks[i]`` with ``conv1..3``, ``bn1..3``, ``proj``,
``bn_proj``, then ``fc_w``, ``fc_b``), the same algebra.  The public
functions take NHWC images as the JAX ones do; inside, activations are
NCHW and convolution weights OIHW (``from_jax_params`` converts HWIO).

Where the two frameworks differ and the port follows JAX:

* ``padding="SAME"`` pads ``total // 2`` low and the rest high, so a stride
  2 convolution or max pool on an even input pads (2, 3) for the 7x7 stem
  and (0, 1) for a 3x3: padded explicitly here, never ``padding=k // 2``;
* batch norm is not ``nn.BatchNorm2d``: statistics in f32 with
  ``var = max(E[x^2] - E[x]^2, 0)``, the scale and shift folded per channel
  and applied in the compute dtype, and the EMA of
  :func:`make_update_stats_fn` folds the biased batch variance;
* the logits are f32: the pooled activation and the fc weights are cast
  before the product.

Convolutions are ``torch.nn.functional.conv2d`` (cuDNN), as the JAX package
leaves them to XLA.  Batch norm in training takes this process's batch
statistics: with one process per rank that is the per-rank BN of the JAX
engine's ring path.  Inside ``collectives.gspmd.global_batch(comm)`` (the
engine's GSPMD mode, and :func:`make_update_stats_fn` given ``comm``) the
per-channel ``(mean, E[x^2])`` pair is averaged over the ranks first, so
the statistics are the global batch's, as in the JAX package's GSPMD step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..collectives import gspmd
from ._common import DeviceLike, generator, num_params, resolve_device  # noqa: F401

Params = Dict[str, Any]

_CONFIGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
_STAGE_WIDTHS = (64, 128, 256, 512)
_CONV_KEYS = ("stem_conv", "conv1", "conv2", "conv3", "proj")


@dataclasses.dataclass(frozen=True)
class Config:
    """Static architecture (the JAX package's fields)."""

    kind: str
    widths: Tuple[int, ...]
    strides: Tuple[int, ...]
    stem_width: int
    n_classes: int
    in_channels: int
    # The 7x7/2 stem as the identical 4x4/1 convolution over space-to-depth
    # input (the JAX package's TPU trick; kept for parity).
    stem_space_to_depth: bool = False

    @property
    def expansion(self) -> int:
        return 1 if self.kind == "basic" else 4


def config(depth: int = 50, n_classes: int = 1000, in_channels: int = 3,
           width_multiplier: float = 1.0,
           stem_space_to_depth: bool = False) -> Config:
    if depth not in _CONFIGS:
        raise ValueError(f"depth must be one of {sorted(_CONFIGS)}")
    kind, stages = _CONFIGS[depth]
    widths, strides = [], []
    for si, n_blocks in enumerate(stages):
        w = max(8, int(_STAGE_WIDTHS[si] * width_multiplier))
        for bi in range(n_blocks):
            widths.append(w)
            strides.append(2 if (si > 0 and bi == 0) else 1)
    return Config(kind=kind, widths=tuple(widths), strides=tuple(strides),
                  stem_width=max(8, int(64 * width_multiplier)),
                  n_classes=n_classes, in_channels=in_channels,
                  stem_space_to_depth=stem_space_to_depth)


# ----------------------------------------------------------------- primitives

def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution, NCHW x OIHW."""
    kh, kw = w.shape[2], w.shape[3]
    ph = _same_pad(x.shape[2], kh, stride)
    pw = _same_pad(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _stem_s2d(x: torch.Tensor, w7: torch.Tensor) -> torch.Tensor:
    """The 7x7/2 SAME stem as a 4x4/1 convolution over 2x2 space-to-depth
    input with padding (1, 2); channel order (a, b, c) as in JAX."""
    N, C, H, W = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"space-to-depth stem needs even H, W; got {H}x{W}")
    xs = (x.reshape(N, C, H // 2, 2, W // 2, 2)       # (N, C, P, a, Q, b)
           .permute(0, 3, 5, 1, 2, 4)                # (N, a, b, C, P, Q)
           .reshape(N, 4 * C, H // 2, W // 2))
    cout, cin, kh, kw = w7.shape
    w8 = F.pad(w7, (0, 8 - kw, 0, 8 - kh))           # (O, C, 8, 8)
    w4 = (w8.reshape(cout, cin, 4, 2, 4, 2)          # (O, C, U, a, V, b)
            .permute(0, 3, 5, 1, 2, 4)               # (O, a, b, C, U, V)
            .reshape(cout, 4 * cin, 4, 4))
    return F.conv2d(F.pad(xs, (1, 2, 1, 2)), w4)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with SAME padding of -inf."""
    ph = _same_pad(x.shape[2], 3, 2)
    pw = _same_pad(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _batch_norm(x: torch.Tensor, p: Params, stats: Optional[Params],
                train: bool, eps: float = 1e-5,
                collect: Optional[list] = None) -> torch.Tensor:
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        msq = (xf * xf).mean(dim=(0, 2, 3))
        comm = gspmd.current()
        if comm is not None:
            mean, msq = gspmd.mean_over_ranks(torch.stack([mean, msq]),
                                              comm).unbind(0)
        var = torch.clamp(msq - mean * mean, min=0.0)
        if collect is not None:
            collect.append((mean, var))
    else:
        mean, var = stats["mean"], stats["var"]
    inv = torch.rsqrt(var + eps)
    w = p["scale"].float()
    scale = (inv * w).to(x.dtype)
    shift = (p["bias"].float() - mean * inv * w).to(x.dtype)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


# --------------------------------------------------------------------- blocks

def _conv_init(gen, kh: int, kw: int, cin: int, cout: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((cout, cin, kh, kw), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * math.sqrt(2.0 / (kh * kw * cin))).to(dtype)


def _bn_init(c: int, dtype, device) -> Params:
    return {"scale": torch.ones(c, dtype=dtype, device=device),
            "bias": torch.zeros(c, dtype=dtype, device=device)}


def _bn_state(c: int, device) -> Params:
    return {"mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def _block_init(gen, kind, cin, width, stride, dtype, device):
    ci = lambda k, a, b: _conv_init(gen, k, k, a, b, dtype, device)
    if kind == "basic":
        cout = width
        p: Params = {"conv1": ci(3, cin, width), "bn1": _bn_init(width, dtype, device),
                     "conv2": ci(3, width, width), "bn2": _bn_init(width, dtype, device)}
        s: Params = {"bn1": _bn_state(width, device), "bn2": _bn_state(width, device)}
    else:
        cout = width * 4
        p = {"conv1": ci(1, cin, width), "bn1": _bn_init(width, dtype, device),
             "conv2": ci(3, width, width), "bn2": _bn_init(width, dtype, device),
             "conv3": ci(1, width, cout), "bn3": _bn_init(cout, dtype, device)}
        s = {"bn1": _bn_state(width, device), "bn2": _bn_state(width, device),
             "bn3": _bn_state(cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = ci(1, cin, cout)
        p["bn_proj"] = _bn_init(cout, dtype, device)
        s["bn_proj"] = _bn_state(cout, device)
    return p, s, cout


def _block_apply(kind, p, s, x, stride, train, collect=None):
    g = lambda name: s[name] if s is not None else None
    bn = lambda h, name: _batch_norm(h, p[name], g(name), train,
                                     collect=collect)
    if kind == "basic":
        out = F.relu(bn(_conv(x, p["conv1"], stride), "bn1"))
        out = bn(_conv(out, p["conv2"]), "bn2")
    else:
        out = F.relu(bn(_conv(x, p["conv1"]), "bn1"))
        out = F.relu(bn(_conv(out, p["conv2"], stride), "bn2"))
        out = bn(_conv(out, p["conv3"]), "bn3")
    if "proj" in p:
        x = bn(_conv(x, p["proj"], stride), "bn_proj")
    return F.relu(out + x)


# ----------------------------------------------------------------- public API

def init(rng, cfg: Config, dtype=torch.float32,
         device: DeviceLike = None) -> Tuple[Params, Params]:
    """(params, state) from a seed or ``torch.Generator``; conv weights
    fan-in scaled by sqrt(2 / fan_in), fc by sqrt(1 / fan_in), as in JAX
    (the draws differ: compare through :func:`from_jax_params`)."""
    dev = resolve_device(device)
    gen = generator(rng, dev)
    params: Params = {
        "stem_conv": _conv_init(gen, 7, 7, cfg.in_channels, cfg.stem_width,
                                dtype, dev),
        "stem_bn": _bn_init(cfg.stem_width, dtype, dev),
        "blocks": [],
    }
    state: Params = {"stem_bn": _bn_state(cfg.stem_width, dev), "blocks": []}
    cin = cfg.stem_width
    for width, stride in zip(cfg.widths, cfg.strides):
        p, s, cin = _block_init(gen, cfg.kind, cin, width, stride, dtype, dev)
        params["blocks"].append(p)
        state["blocks"].append(s)
    fc = torch.randn((cin, cfg.n_classes), generator=gen, device=dev)
    params["fc_w"] = (fc * math.sqrt(1.0 / cin)).to(dtype)
    params["fc_b"] = torch.zeros(cfg.n_classes, dtype=dtype, device=dev)
    return params, state


def _to_torch(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def from_jax_params(params: Params, device: DeviceLike = None) -> Params:
    """A JAX parameter tree (numpy or jax arrays, f32) as the port's:
    convolution weights HWIO -> OIHW, everything else as it is."""
    dev = resolve_device(device)

    def conv(key, a):
        t = _to_torch(a, dev)
        return t.permute(3, 2, 0, 1).contiguous() if key in _CONV_KEYS else t

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return conv(key, tree)

    return walk(params)


def from_jax_state(state: Params, device: DeviceLike = None) -> Params:
    """A JAX BN-state tree as the port's (f32 tensors)."""
    dev = resolve_device(device)
    if isinstance(state, dict):
        return {k: from_jax_state(v, dev) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [from_jax_state(v, dev) for v in state]
    return _to_torch(state, dev)


def apply(cfg: Config, params: Params, x: torch.Tensor,
          state: Optional[Params] = None, train: bool = True,
          _collect: Optional[list] = None) -> torch.Tensor:
    """Forward pass over NHWC images; f32 logits ``(N, n_classes)``.
    ``state`` (BN running statistics) is needed only with ``train=False``."""
    sblocks = (state["blocks"] if state is not None
               else [None] * len(params["blocks"]))
    h = x.permute(0, 3, 1, 2).contiguous()
    if cfg.stem_space_to_depth:
        h = _stem_s2d(h, params["stem_conv"])
    else:
        h = _conv(h, params["stem_conv"], stride=2)
    h = F.relu(_batch_norm(h, params["stem_bn"],
                           state["stem_bn"] if state else None, train,
                           collect=_collect))
    h = _max_pool(h)
    for p, s, stride in zip(params["blocks"], sblocks, cfg.strides):
        h = _block_apply(cfg.kind, p, s, h, stride, train, collect=_collect)
    h = h.mean(dim=(2, 3))
    return h.float() @ params["fc_w"].float() + params["fc_b"].float()


def make_update_stats_fn(cfg: Config, momentum: float = 0.9, comm=None):
    """``(params, state, x) -> new_state``: one training-mode forward whose
    per-BN batch statistics EMA-update the running statistics.  With
    ``comm`` the statistics are those of the global batch, every rank's
    ``x`` together (the JAX example folds the global batch): each rank
    then holds the same running statistics."""

    def update(params: Params, state: Params, x: torch.Tensor) -> Params:
        collected: List[Tuple[torch.Tensor, torch.Tensor]] = []
        with torch.no_grad(), gspmd.global_batch(comm):
            apply(cfg, params, x, train=True, _collect=collected)
        it = iter(collected)

        def fold(stats: Params) -> Params:
            mean, var = next(it)
            return {"mean": momentum * stats["mean"] + (1.0 - momentum) * mean,
                    "var": momentum * stats["var"] + (1.0 - momentum) * var}

        new_state: Params = {"stem_bn": fold(state["stem_bn"]), "blocks": []}
        for sb in state["blocks"]:
            new_state["blocks"].append(
                {key: fold(sb[key]) for key in ("bn1", "bn2", "bn3", "bn_proj")
                 if key in sb})
        if next(it, None) is not None:
            raise AssertionError("BN statistics traversal mismatch")
        return new_state

    return update


def make_loss_fn(cfg: Config):
    """Mean softmax cross-entropy in training mode (this process's BN
    statistics, or the global batch's inside ``gspmd.global_batch``): the
    ``loss_fn(params, batch)`` the engine takes."""

    def loss_fn(params: Params, batch) -> torch.Tensor:
        x, y = batch
        logp = F.log_softmax(apply(cfg, params, x, train=True), dim=-1)
        return -logp.gather(1, y.long()[:, None]).mean()

    return loss_fn


def make_accuracy_fn(cfg: Config, state: Optional[Params] = None):
    """Accuracy for ``engine.test``: inference mode with ``state``, batch
    statistics without it."""

    def accuracy(params: Params, batch) -> torch.Tensor:
        x, y = batch
        logits = apply(cfg, params, x, state=state, train=state is None)
        return (logits.argmax(dim=-1) == y.long()).float().mean()

    return accuracy


def flops_per_image(cfg: Config, image: int = 224) -> int:
    """Analytic forward FLOPs per image (a multiply-add is 2), convolutions
    and the fc only; a training step is about 3x."""

    def conv(h, w, kh, kw, cin, cout, stride):
        ho, wo = -(-h // stride), -(-w // stride)
        return 2 * ho * wo * kh * kw * cin * cout, ho, wo

    total = 0
    fl, h, w = conv(image, image, 7, 7, cfg.in_channels, cfg.stem_width, 2)
    total += fl
    h, w = -(-h // 2), -(-w // 2)
    cin = cfg.stem_width
    for width, stride in zip(cfg.widths, cfg.strides):
        if cfg.kind == "basic":
            fl, h, w = conv(h, w, 3, 3, cin, width, stride)
            total += fl
            fl, _, _ = conv(h, w, 3, 3, width, width, 1)
            total += fl
            cout = width
        else:
            fl, _, _ = conv(h, w, 1, 1, cin, width, 1)
            total += fl
            fl, h, w = conv(h, w, 3, 3, width, width, stride)
            total += fl
            fl, _, _ = conv(h, w, 1, 1, width, width * 4, 1)
            total += fl
            cout = width * 4
        if stride != 1 or cin != cout:
            total += 2 * h * w * cin * cout
        cin = cout
    total += 2 * cin * cfg.n_classes
    return total
