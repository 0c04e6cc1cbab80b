"""VGG16 — the reference app's actual model, as a tappable node plugin.

The reference exploded torchvision VGG16 into 42 graph nodes named
``vgg16:transform``, ``vgg16:features.0``..``features.30``, ``vgg16:avgpool``,
``vgg16:flatten``, ``vgg16:classifier.0``..``classifier.6``
(``/root/reference/static/models/vgg16.py:31-35`` + ``main/context.py:44-47``)
and saved the auto-generated chain to ``static/graphs/vgg16.json``. This
module reproduces that EXACT node-name surface — the reference's saved
vgg16.json evaluates against this server verbatim — with jax compute:
convs lower through XLA (cuDNN on the GPU), the whole tapped chain stages
into one program.

Weights: random init by default (zero-egress environment); the
``from_torchvision`` converter loads real torchvision ``vgg16`` state dicts.
Eval semantics: Dropout = identity, accepts [3,H,W] (the reference ran
unbatched — torch convs accept 3-D) or [B,3,H,W].
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]

# torchvision vgg16.features layout: (layer_kind, out_channels) per index
_FEATURES: List[Tuple[str, int]] = []
_cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M"]
for _v in _cfg:
    if _v == "M":
        _FEATURES.append(("maxpool", 0))
    else:
        _FEATURES.append(("conv", _v))
        _FEATURES.append(("relu", 0))

# classifier: Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear
_CLASSIFIER = ["linear", "relu", "dropout", "linear", "relu", "dropout", "linear"]
_CLASSIFIER_DIMS = [(25088, 4096), None, None, (4096, 4096), None, None, (4096, 1000)]


def _ensure_batched(x):
    return (x[None], True) if x.ndim == 3 else (x, False)


def conv2d(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """3x3 same-pad conv, NCHW/OIHW, f32-accumulated.

    Activations adopt the weight dtype (bf16 serving path)."""
    x = x.astype(w.dtype)
    xb, squeeze = _ensure_batched(x)
    y = jax.lax.conv_general_dilated(
        xb, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
        precision=L.mm_precision(xb, w),
    ).astype(x.dtype) + b.reshape(1, -1, 1, 1).astype(x.dtype)
    return y[0] if squeeze else y


def maxpool2(x: jnp.ndarray) -> jnp.ndarray:
    xb, squeeze = _ensure_batched(x)
    y = jax.lax.reduce_window(
        xb, -jnp.inf, jax.lax.max,
        window_dimensions=(1, 1, 2, 2), window_strides=(1, 1, 2, 2),
        padding="VALID",
    )
    return y[0] if squeeze else y


def adaptive_avgpool7(x: jnp.ndarray) -> jnp.ndarray:
    """AdaptiveAvgPool2d((7,7)) with exact torch window semantics:
    out[i] = mean(x[floor(i*H/7) : ceil((i+1)*H/7)]) — works for any input
    size (smaller than 7 repeats rows, 224-input is the identity 7x7)."""
    xb, squeeze = _ensure_batched(x)

    def pool_axis(t, axis, out_size):
        size_in = t.shape[axis]
        parts = []
        for i in range(out_size):
            s = (i * size_in) // out_size
            e = -(-((i + 1) * size_in) // out_size)
            parts.append(
                jnp.mean(jax.lax.slice_in_dim(t, s, e, axis=axis),
                         axis=axis, keepdims=True)
            )
        return jnp.concatenate(parts, axis=axis)

    if xb.shape[-2:] != (7, 7):
        xb = pool_axis(pool_axis(xb, -2, 7), -1, 7)
    return xb[0] if squeeze else xb


def flatten(x: jnp.ndarray) -> jnp.ndarray:
    """torch.flatten semantics of the reference (``vgg16.py:44``): full
    flatten for unbatched input, per-sample flatten for batched."""
    if x.ndim == 3:
        return x.reshape(-1)
    return x.reshape(x.shape[0], -1)


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, dtype=jnp.float32) -> Params:
    """Random He-style init matching the torchvision layer layout."""
    params: Params = {"features": {}, "classifier": {}}
    keys = iter(jax.random.split(key, 32))
    in_ch = 3
    for idx, (kind, out_ch) in enumerate(_FEATURES):
        if kind == "conv":
            fan_in = in_ch * 9
            params["features"][str(idx)] = {
                "w": (jax.random.normal(next(keys), (out_ch, in_ch, 3, 3),
                                        jnp.float32)
                      * (2.0 / fan_in) ** 0.5).astype(dtype),
                "b": jnp.zeros((out_ch,), dtype),
            }
            in_ch = out_ch
    for idx, dims in enumerate(_CLASSIFIER_DIMS):
        if dims is not None:
            params["classifier"][str(idx)] = {
                "w": (jax.random.normal(next(keys), dims, jnp.float32)
                      * (1.0 / dims[0]) ** 0.5).astype(dtype),
                "b": jnp.zeros((dims[1],), dtype),
            }
    return params


def from_torchvision(sd: Dict[str, Any], dtype=jnp.float32) -> Params:
    """torchvision ``vgg16().state_dict()`` (as numpy) -> our pytree."""
    import numpy as np

    params: Params = {"features": {}, "classifier": {}}
    for idx, (kind, _) in enumerate(_FEATURES):
        if kind == "conv":
            params["features"][str(idx)] = {
                "w": jnp.asarray(np.asarray(sd[f"features.{idx}.weight"]), dtype),
                "b": jnp.asarray(np.asarray(sd[f"features.{idx}.bias"]), dtype),
            }
    for idx, dims in enumerate(_CLASSIFIER_DIMS):
        if dims is not None:
            params["classifier"][str(idx)] = {
                "w": jnp.asarray(
                    np.asarray(sd[f"classifier.{idx}.weight"]).T, dtype
                ),
                "b": jnp.asarray(np.asarray(sd[f"classifier.{idx}.bias"]), dtype),
            }
    return params


# -- layer decomposition (the 42-node surface) -----------------------------------


def layer_fns():
    """Ordered (name, extra_outs, fn) specs matching the reference's node
    list (``vgg16.py:31-35``): transform, features.0-30, avgpool, flatten,
    classifier.0-6."""
    layers = []

    from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

    layers.append(("transform", [],
                   lambda p, ins: {"o": preprocess_mm(ins["o"], 224)}))

    def conv_fn(p, ins):
        return {"o": conv2d(ins["o"], p["w"], p["b"])}

    def relu_fn(p, ins):
        return {"o": jax.nn.relu(ins["o"])}

    def maxpool_fn(p, ins):
        return {"o": maxpool2(ins["o"])}

    for idx, (kind, _) in enumerate(_FEATURES):
        fn = {"conv": conv_fn, "relu": relu_fn, "maxpool": maxpool_fn}[kind]
        layers.append((f"features.{idx}", [], fn))

    layers.append(("avgpool", [], lambda p, ins: {"o": adaptive_avgpool7(ins["o"])}))
    layers.append(("flatten", [], lambda p, ins: {"o": flatten(ins["o"])}))

    def linear_fn(p, ins):
        return {"o": L.linear(ins["o"], p["w"], p["b"])}

    def identity_fn(p, ins):
        return {"o": ins["o"]}

    for idx, kind in enumerate(_CLASSIFIER):
        fn = {"linear": linear_fn, "relu": relu_fn, "dropout": identity_fn}[kind]
        layers.append((f"classifier.{idx}", [], fn))

    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name.startswith("features."):
        return params["features"].get(layer_name.split(".", 1)[1], {})
    if layer_name.startswith("classifier."):
        return params["classifier"].get(layer_name.split(".", 1)[1], {})
    return {}


def forward(params: Params, images: jnp.ndarray) -> jnp.ndarray:
    """Monolithic forward (logits) — shares the layer fns exactly."""
    env = {"o": images}
    for name, _, fn in layer_fns():
        if name == "transform":
            continue
        env = fn(layer_params(params, name), env)
    return env["o"]
