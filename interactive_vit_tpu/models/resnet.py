"""ResNet-50 — a third model-architecture class as a tappable node plugin.

The reference wrapped ONE torchvision model generically
(``/root/reference/main/context.py:38-47`` ``Model(nn.Module)``, exploded
per named child into graph nodes) — VGG16 in practice. This framework's
equivalent generality is the ``JaxModel`` plugin API; ResNet-50 proves it
on the residual-CNN class (stride-2 bottlenecks, batch-norm inference,
global pooling), the architecture torchvision users reach for first.

Node surface mirrors torchvision ``resnet50`` named children, one node
per bottleneck block (the tappable granularity a viewer wants):

    resnet50:transform, conv1, maxpool, layer1.0 .. layer4.2,
    avgpool, fc                                  (21 compute nodes)

(bn1 + relu fold into the conv1 node: eval-mode BN is an affine the
XLA fusion absorbs; exposing it as its own node would tap a tensor
torchvision users never see alone either.)

Weights: random init by default (zero-egress image); ``from_torchvision``
loads real ``resnet50`` state dicts (also via serving ``--ckpt``, layout
auto-detected). Eval semantics: BN uses running stats; accepts [3,H,W]
or [B,3,H,W].

Notes: every conv lowers through ``jax.lax.conv_general_dilated``
(cuDNN on the GPU) with f32 accumulation (``mm_precision`` policy); BN
folds to scale+shift at conversion time so serving does one multiply-add
per channel instead of rsqrt chains.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]

# bottleneck counts and widths per stage (torchvision resnet50)
STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]
EXPANSION = 4
BN_EPS = 1e-5


def _ensure_batched(x):
    return (x[None], True) if x.ndim == 3 else (x, False)


def conv(x, w, stride=1, padding="SAME"):
    """NCHW/OIHW conv, f32-accumulated; activations adopt weight dtype."""
    x = x.astype(w.dtype)
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
        precision=L.mm_precision(x, w),
    ).astype(w.dtype)


def bn(x, p):
    """Eval-mode batch norm as the folded affine: p = {"s", "b"} with
    s = gamma / sqrt(var + eps), b = beta - mean * s (folded by
    ``fold_bn`` at init/conversion)."""
    s = p["s"].reshape(1, -1, 1, 1).astype(x.dtype)
    b = p["b"].reshape(1, -1, 1, 1).astype(x.dtype)
    return x * s + b


def fold_bn(gamma, beta, mean, var, eps=BN_EPS):
    s = np.asarray(gamma) / np.sqrt(np.asarray(var) + eps)
    return {"s": jnp.asarray(s, jnp.float32),
            "b": jnp.asarray(np.asarray(beta) - np.asarray(mean) * s,
                             jnp.float32)}


def maxpool3_s2(x):
    """torchvision's maxpool: kernel 3, stride 2, padding 1."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 2, 2),
        ((0, 0), (0, 0), (1, 1), (1, 1)),
    ).astype(x.dtype)


def bottleneck(p: Params, x: jnp.ndarray, stride: int) -> jnp.ndarray:
    """conv1x1 -> BN -> relu -> conv3x3(s) -> BN -> relu -> conv1x1 ->
    BN -> +identity/downsample -> relu (torchvision Bottleneck)."""
    idn = x
    y = jax.nn.relu(bn(conv(x, p["conv1_w"]), p["bn1"]))
    # explicit symmetric pad 1: "SAME" at stride 2 pads asymmetrically
    # (TF convention) and diverges from torch's padding=1
    y = jax.nn.relu(bn(conv(y, p["conv2_w"], stride=stride,
                            padding=[(1, 1), (1, 1)]), p["bn2"]))
    y = bn(conv(y, p["conv3_w"]), p["bn3"])
    if "down_w" in p:
        idn = bn(conv(x, p["down_w"], stride=stride), p["down_bn"])
    return jax.nn.relu(y + idn.astype(y.dtype))


def global_avgpool(x):
    return jnp.mean(x.astype(jnp.float32), axis=(2, 3)).astype(x.dtype)


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, num_classes: int = 1000,
                dtype=jnp.float32) -> Params:
    """He-style random init with identity BN folds."""
    keys = iter(jax.random.split(key, 4 + sum(n for n, _ in STAGES) * 4 + 2))

    def kconv(cin, cout, k):
        fan = cin * k * k
        return (jax.random.normal(next(keys), (cout, cin, k, k), jnp.float32)
                * (2.0 / fan) ** 0.5).astype(dtype)

    def ident_bn(c):
        return {"s": jnp.ones((c,), jnp.float32),
                "b": jnp.zeros((c,), jnp.float32)}

    params: Params = {
        "conv1_w": kconv(3, 64, 7),
        "bn1": ident_bn(64),
        "layers": [],
    }
    cin = 64
    for si, (blocks, width) in enumerate(STAGES):
        stage = []
        cout = width * EXPANSION
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {
                "conv1_w": kconv(cin, width, 1),
                "bn1": ident_bn(width),
                "conv2_w": kconv(width, width, 3),
                "bn2": ident_bn(width),
                "conv3_w": kconv(width, cout, 1),
                "bn3": ident_bn(cout),
            }
            if stride != 1 or cin != cout:
                blk["down_w"] = kconv(cin, cout, 1)
                blk["down_bn"] = ident_bn(cout)
            stage.append(blk)
            cin = cout
        params["layers"].append(stage)
    params["fc"] = {
        "w": (jax.random.normal(next(keys), (cin, num_classes), jnp.float32)
              * cin ** -0.5).astype(dtype),
        "b": jnp.zeros((num_classes,), dtype),
    }
    return params


def from_torchvision(sd: Dict[str, Any], dtype=jnp.float32) -> Params:
    """torchvision ``resnet50`` state dict -> our pytree (BN folded).

    Contract parity: ``/root/reference/static/models/vgg16.py:11-14``'s
    pretrained-download story, generalized to the resnet family."""
    def get(name):
        if name not in sd:
            raise KeyError(f"state dict missing {name!r}")
        return np.asarray(sd[name], np.float32)

    def get_bn(pre):
        return fold_bn(get(pre + ".weight"), get(pre + ".bias"),
                       get(pre + ".running_mean"), get(pre + ".running_var"))

    params: Params = {
        "conv1_w": jnp.asarray(get("conv1.weight"), dtype),
        "bn1": get_bn("bn1"),
        "layers": [],
    }
    for si, (blocks, _w) in enumerate(STAGES):
        stage = []
        for bi in range(blocks):
            pre = f"layer{si + 1}.{bi}."
            blk = {
                "conv1_w": jnp.asarray(get(pre + "conv1.weight"), dtype),
                "bn1": get_bn(pre + "bn1"),
                "conv2_w": jnp.asarray(get(pre + "conv2.weight"), dtype),
                "bn2": get_bn(pre + "bn2"),
                "conv3_w": jnp.asarray(get(pre + "conv3.weight"), dtype),
                "bn3": get_bn(pre + "bn3"),
            }
            if (pre + "downsample.0.weight") in sd:
                blk["down_w"] = jnp.asarray(
                    get(pre + "downsample.0.weight"), dtype)
                blk["down_bn"] = get_bn(pre + "downsample.1")
            stage.append(blk)
        params["layers"].append(stage)
    params["fc"] = {
        "w": jnp.asarray(get("fc.weight").T, dtype),
        "b": jnp.asarray(get("fc.bias"), dtype),
    }
    return params


def forward(params: Params, images: jnp.ndarray) -> jnp.ndarray:
    """[B,3,H,W] (or [3,H,W]) -> logits [B,num_classes]."""
    x, squeeze = _ensure_batched(images)
    x = jax.nn.relu(bn(conv(x, params["conv1_w"], stride=2,
                            padding=[(3, 3), (3, 3)]), params["bn1"]))
    x = maxpool3_s2(x)
    for si, stage in enumerate(params["layers"]):
        for bi, blk in enumerate(stage):
            x = bottleneck(blk, x, 2 if (si > 0 and bi == 0) else 1)
    x = global_avgpool(x)
    logits = L.linear(x, params["fc"]["w"], params["fc"]["b"])
    return logits[0] if squeeze else logits


# -- node decomposition -----------------------------------------------------------


def layer_fns() -> List[Tuple[str, List[str], Callable]]:
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

        return {"o": preprocess_mm(ins["o"], 224)}

    def conv1_fn(p, ins):
        x, squeeze = _ensure_batched(ins["o"])
        y = jax.nn.relu(bn(conv(x, p["conv1_w"], stride=2,
                               padding=[(3, 3), (3, 3)]), p["bn1"]))
        return {"o": y[0] if squeeze else y}

    def maxpool_fn(p, ins):
        x, squeeze = _ensure_batched(ins["o"])
        y = maxpool3_s2(x)
        return {"o": y[0] if squeeze else y}

    layers.append(("transform", [], transform_fn))
    layers.append(("conv1", [], conv1_fn))
    layers.append(("maxpool", [], maxpool_fn))

    def make_block_fn(si, bi):
        stride = 2 if (si > 0 and bi == 0) else 1

        def block_fn(p, ins):
            x, squeeze = _ensure_batched(ins["o"])
            y = bottleneck(p, x, stride)
            return {"o": y[0] if squeeze else y}

        return block_fn

    for si, (blocks, _w) in enumerate(STAGES):
        for bi in range(blocks):
            layers.append((f"layer{si + 1}.{bi}", [], make_block_fn(si, bi)))

    def avgpool_fn(p, ins):
        x, squeeze = _ensure_batched(ins["o"])
        y = global_avgpool(x)
        return {"o": y[0] if squeeze else y}

    def fc_fn(p, ins):
        x = ins["o"]
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        y = L.linear(x, p["w"], p["b"])
        return {"o": y[0] if squeeze else y}

    layers.append(("avgpool", [], avgpool_fn))
    layers.append(("fc", [], fc_fn))
    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name in ("transform", "maxpool", "avgpool"):
        return None
    if layer_name == "conv1":
        return {"conv1_w": params["conv1_w"], "bn1": params["bn1"]}
    if layer_name == "fc":
        return params["fc"]
    if layer_name.startswith("layer"):
        stage, bi = layer_name[5:].split(".")
        return params["layers"][int(stage) - 1][int(bi)]
    raise KeyError(layer_name)
