"""ConvNeXt (tiny/small/base) — the modern-conv architecture class as a
tappable node plugin.

Fourth architecture family through the plugin API (after ViT, residual
CNNs, and hierarchical windowed transformers), mirroring the reference's
generic one-model-many-nodes explosion
(``/root/reference/main/context.py:38-47``). Structure and state-dict
naming follow torchvision ``convnext_tiny/small/base``: a 4x4/4 stem,
four stages of CNBlocks (7x7 depthwise conv -> channel LayerNorm ->
pointwise MLP with GELU -> layer-scale residual), LayerNorm+2x2/2
downsampling between stages, and an avgpool -> LayerNorm -> Linear head.
Stochastic depth is identity at eval (this framework's serving/replay
semantics), matching torch eval mode.

Design: activations stay **NHWC end-to-end** — the FLOPs live in the
pointwise MLPs, which are plain channel-last matmuls with no
layout moves (torchvision permutes NCHW<->NHWC around every block; here
the permute happens once at the stem). The 7x7 depthwise conv lowers via
``lax.conv_general_dilated`` with ``feature_group_count=C`` (memory-bound,
<2% of FLOPs). All dots/convs accumulate f32 (``mm_precision``,
CLAUDE.md trap #4). Stage taps are spatial ``[B, H, W, C]`` — the same
rank the dense-feature viewers (pca_view/patch_sim) already accept for
swin stages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = 1000
    img_size: int = 224
    # torchvision eval recipe: bilinear shorter-side resize to this, then
    # center-crop img_size (ImageClassification meta per variant)
    resize_to: int = 236
    ln_eps: float = 1e-6
    layer_scale: float = 1e-6

    def stage_res(self, s: int) -> int:
        return self.img_size // 4 // (2 ** s)


VARIANTS: Dict[str, ConvNeXtConfig] = {
    "convnext_t": ConvNeXtConfig("convnext_t"),
    "convnext_s": ConvNeXtConfig("convnext_s", depths=(3, 3, 27, 3),
                                 resize_to=230),
    "convnext_b": ConvNeXtConfig("convnext_b", depths=(3, 3, 27, 3),
                                 dims=(128, 256, 512, 1024),
                                 resize_to=232),
}


def _ensure_batched(x):
    return (x[None], True) if x.ndim == 3 else (x, False)


def _ln(x, p, eps):
    """LayerNorm over the channel (last) axis, f32 statistics."""
    xf = x.astype(jnp.float32)
    mu = xf.mean(axis=-1, keepdims=True)
    var = xf.var(axis=-1, keepdims=True)
    y = (xf - mu) * jax.lax.rsqrt(var + eps)
    return (y * p["g"].astype(jnp.float32)
            + p["b"].astype(jnp.float32)).astype(x.dtype)


def _conv_nhwc(x, w, b, stride: int, padding, groups: int = 1):
    """NHWC x HWIO conv, f32-accumulated; activations adopt weight dtype."""
    x = x.astype(w.dtype)
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
        preferred_element_type=jnp.float32,
        precision=L.mm_precision(x, w),
    )
    return (y + b.astype(jnp.float32)).astype(w.dtype)


def stem(p: Params, images: jnp.ndarray, cfg: ConvNeXtConfig) -> jnp.ndarray:
    """[B,3,H,W] -> NHWC patch features [B, H/4, W/4, C0] (4x4/4 conv +
    channel LN — torchvision ``features.0``)."""
    x = jnp.transpose(images, (0, 2, 3, 1))  # one NCHW->NHWC, then stay
    x = _conv_nhwc(x, p["w"], p["b"], 4, "VALID")
    return _ln(x, p["ln"], cfg.ln_eps)


def block(p: Params, x: jnp.ndarray, cfg: ConvNeXtConfig) -> jnp.ndarray:
    """CNBlock: dw7x7 -> LN -> Linear(4C) -> GELU -> Linear(C) ->
    layer_scale -> +residual (torchvision CNBlock, eval mode)."""
    c = x.shape[-1]
    y = _conv_nhwc(x, p["dw_w"], p["dw_b"], 1, [(3, 3), (3, 3)], groups=c)
    y = _ln(y, p["ln"], cfg.ln_eps)
    y = L.linear(y, p["fc1"]["w"], p["fc1"]["b"])
    y = jax.nn.gelu(y.astype(jnp.float32), approximate=False).astype(y.dtype)
    y = L.linear(y, p["fc2"]["w"], p["fc2"]["b"])
    return x + (p["gamma"].astype(jnp.float32) * y.astype(jnp.float32)
                ).astype(x.dtype)


def downsample(p: Params, x: jnp.ndarray, cfg: ConvNeXtConfig) -> jnp.ndarray:
    """Between stages: channel LN then 2x2/2 conv (torchvision's
    ``features.{2,4,6}``)."""
    x = _ln(x, p["ln"], cfg.ln_eps)
    return _conv_nhwc(x, p["w"], p["b"], 2, "VALID")


def head(p: Params, pooled: jnp.ndarray, cfg: ConvNeXtConfig) -> jnp.ndarray:
    """[B, C] pooled features -> logits (LN -> Linear; torchvision
    ``classifier.{0,2}`` — the LN sits AFTER the global pool)."""
    return L.linear(_ln(pooled, p["ln"], cfg.ln_eps),
                    p["fc"]["w"], p["fc"]["b"])


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: ConvNeXtConfig,
                dtype=jnp.float32) -> Params:
    """torchvision's init: trunc-normal(0.02) conv/linear weights, zero
    biases, unit LN scales, ``layer_scale``-filled gammas."""
    n_keys = 2 + sum(cfg.depths) * 3 + len(cfg.depths)
    keys = iter(jax.random.split(key, n_keys))

    def tn(shape):
        return (jax.random.truncated_normal(
            next(keys), -2.0, 2.0, shape, jnp.float32) * 0.02).astype(dtype)

    def ln(c):
        return {"g": jnp.ones((c,), jnp.float32),
                "b": jnp.zeros((c,), jnp.float32)}

    dims = cfg.dims
    params: Params = {
        "stem": {"w": tn((4, 4, 3, dims[0])),
                 "b": jnp.zeros((dims[0],), dtype), "ln": ln(dims[0])},
        "stages": [],
        "downs": [],
    }
    for s, depth in enumerate(cfg.depths):
        c = dims[s]
        stage = []
        for _ in range(depth):
            stage.append({
                "dw_w": tn((7, 7, 1, c)),
                "dw_b": jnp.zeros((c,), dtype),
                "ln": ln(c),
                "fc1": {"w": tn((c, 4 * c)), "b": jnp.zeros((4 * c,), dtype)},
                "fc2": {"w": tn((4 * c, c)), "b": jnp.zeros((c,), dtype)},
                "gamma": jnp.full((c,), cfg.layer_scale, jnp.float32),
            })
        params["stages"].append(stage)
        if s + 1 < len(cfg.depths):
            params["downs"].append({
                "ln": ln(c),
                "w": tn((2, 2, c, dims[s + 1])),
                "b": jnp.zeros((dims[s + 1],), dtype),
            })
    params["head"] = {
        "ln": ln(dims[-1]),
        "fc": {"w": tn((dims[-1], cfg.num_classes)),
               "b": jnp.zeros((cfg.num_classes,), dtype)},
    }
    return params


def from_torchvision(sd: Dict[str, Any], cfg: ConvNeXtConfig,
                     dtype=jnp.float32) -> Params:
    """torchvision ``convnext_*`` state dict -> our pytree.

    Feature indices: stem=0, stages at 1/3/5/7, downsamples at 2/4/6;
    block body keys ``block.{0,2,3,5}`` + ``layer_scale``; classifier
    ``{0,2}``. Conv weights transpose OIHW -> HWIO (the depthwise
    [C,1,7,7] becomes [7,7,1,C] — the grouped-HWIO layout)."""
    def get(name):
        if name not in sd:
            raise KeyError(f"state dict missing {name!r}")
        return np.asarray(sd[name], np.float32)

    def conv_w(name):
        return jnp.asarray(get(name).transpose(2, 3, 1, 0), dtype)

    def ln(pre):
        return {"g": jnp.asarray(get(pre + ".weight"), jnp.float32),
                "b": jnp.asarray(get(pre + ".bias"), jnp.float32)}

    def lin(pre):
        return {"w": jnp.asarray(get(pre + ".weight").T, dtype),
                "b": jnp.asarray(get(pre + ".bias"), dtype)}

    params: Params = {
        "stem": {"w": conv_w("features.0.0.weight"),
                 "b": jnp.asarray(get("features.0.0.bias"), dtype),
                 "ln": ln("features.0.1")},
        "stages": [], "downs": [],
    }
    for s, depth in enumerate(cfg.depths):
        fi = 1 + 2 * s
        stage = []
        for b in range(depth):
            pre = f"features.{fi}.{b}."
            stage.append({
                "dw_w": conv_w(pre + "block.0.weight"),
                "dw_b": jnp.asarray(get(pre + "block.0.bias"), dtype),
                "ln": ln(pre + "block.2"),
                "fc1": lin(pre + "block.3"),
                "fc2": lin(pre + "block.5"),
                "gamma": jnp.asarray(
                    get(pre + "layer_scale").reshape(-1), jnp.float32),
            })
        params["stages"].append(stage)
        if s + 1 < len(cfg.depths):
            di = fi + 1
            params["downs"].append({
                "ln": ln(f"features.{di}.0"),
                "w": conv_w(f"features.{di}.1.weight"),
                "b": jnp.asarray(get(f"features.{di}.1.bias"), dtype),
            })
    params["head"] = {"ln": ln("classifier.0"), "fc": lin("classifier.2")}
    return params


def forward(params: Params, images: jnp.ndarray,
            cfg: ConvNeXtConfig, block_wrapper=None) -> jnp.ndarray:
    """[B,3,H,W] (or [3,H,W]) -> logits [B, num_classes].

    ``block_wrapper``: training hook — each CNBlock becomes one
    rematerialization unit (``jax.checkpoint`` via
    ``parallel/train.remat_wrapper``), same contract as the vit/swin
    trunks."""
    x, squeeze = _ensure_batched(images)
    x = stem(params["stem"], x, cfg)
    one = (block_wrapper(lambda p, y: block(p, y, cfg))
           if block_wrapper is not None else None)
    for s, stage in enumerate(params["stages"]):
        for blk in stage:
            x = one(blk, x) if one is not None else block(blk, x, cfg)
        if s < len(params["downs"]):
            x = downsample(params["downs"][s], x, cfg)
    pooled = x.astype(jnp.float32).mean(axis=(1, 2)).astype(x.dtype)
    logits = head(params["head"], pooled, cfg)
    return logits[0] if squeeze else logits


# -- node decomposition ----------------------------------------------------


def layer_fns(cfg: ConvNeXtConfig) -> List[Tuple[str, List[str], Callable]]:
    """Tappable surface: transform, stem, stages.{s}.{b},
    downsample.{s} (s = 1..3, the stage it feeds), avgpool, head —
    25 nodes for convnext_t. Stage taps are NHWC [B,H,W,C] (dense-feature
    viewers render them directly)."""
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], cfg.img_size,
                                   resize_to=cfg.resize_to)}

    def stem_fn(p, ins):
        x, squeeze = _ensure_batched(ins["o"])
        y = stem(p, x, cfg)
        return {"o": y[0] if squeeze else y}

    layers.append(("transform", [], transform_fn))
    layers.append(("stem", [], stem_fn))

    def make_block_fn():
        def block_fn(p, ins):
            x = ins["o"]
            squeeze = x.ndim == 3
            if squeeze:
                x = x[None]
            y = block(p, x, cfg)
            return {"o": y[0] if squeeze else y}

        return block_fn

    def make_down_fn():
        def down_fn(p, ins):
            x = ins["o"]
            squeeze = x.ndim == 3
            if squeeze:
                x = x[None]
            y = downsample(p, x, cfg)
            return {"o": y[0] if squeeze else y}

        return down_fn

    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            layers.append((f"stages.{s}.{b}", [], make_block_fn()))
        if s + 1 < len(cfg.depths):
            layers.append((f"downsample.{s + 1}", [], make_down_fn()))

    def avgpool_fn(p, ins):
        x = ins["o"]
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        y = x.astype(jnp.float32).mean(axis=(1, 2)).astype(x.dtype)
        return {"o": y[0] if squeeze else y}

    def head_fn(p, ins):
        x = ins["o"]
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        y = head(p, x, cfg)
        return {"o": y[0] if squeeze else y}

    layers.append(("avgpool", [], avgpool_fn))
    layers.append(("head", [], head_fn))
    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name in ("transform", "avgpool"):
        return None
    if layer_name == "stem":
        return params["stem"]
    if layer_name == "head":
        return params["head"]
    if layer_name.startswith("stages."):
        _, s, b = layer_name.split(".")
        return params["stages"][int(s)][int(b)]
    if layer_name.startswith("downsample."):
        return params["downs"][int(layer_name.split(".")[1]) - 1]
    raise KeyError(layer_name)
