"""CLIP image encoder (ViT-B/32) — the embedding-extraction node path.

BASELINE.json config 4: "CLIP ViT-B/32 image encoder (embedding extraction
node path)". Proves the model-plugin API generalizes beyond classifiers: the
chain ends in an *embedding* node (L2-normalized [B, 512] vector) instead of
a category head.

Architecture follows OpenAI CLIP's visual tower: stride-32 patch conv
WITHOUT bias, class embedding + learned positions, ``ln_pre`` before the
transformer, pre-LN blocks with QuickGELU (x * sigmoid(1.702 x)), ``ln_post``
on the CLS token, then a bias-free projection to the shared embedding space.
Weight converter handles OpenAI state-dict naming (``visual.*``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.ops import attention as attn_ops
from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    name: str = "clip_b32"
    img_size: int = 224
    patch: int = 32
    width: int = 768
    depth: int = 12
    heads: int = 12
    embed_dim: int = 512
    ln_eps: float = 1e-5

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 1

    @property
    def mlp_dim(self) -> int:
        return self.width * 4


def quick_gelu(x: jnp.ndarray) -> jnp.ndarray:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * jax.nn.sigmoid(1.702 * x)


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: CLIPVisionConfig,
                dtype=jnp.float32) -> Params:
    keys = iter(jax.random.split(key, 8 + 4 * cfg.depth))
    d, md = cfg.width, cfg.mlp_dim
    pdim = 3 * cfg.patch * cfg.patch

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(dtype)

    params: Params = {
        "patch_embed": {"w": dense(next(keys), pdim, (pdim, d))},  # no bias
        "cls_token": (jax.random.normal(next(keys), (1, 1, d), jnp.float32)
                      * d ** -0.5).astype(dtype),
        "pos_emb": (jax.random.normal(next(keys), (1, cfg.tokens, d),
                                      jnp.float32) * 0.01).astype(dtype),
        "ln_pre": {"s": jnp.ones((d,), dtype), "b": jnp.zeros((d,), dtype)},
        "blocks": [],
        "ln_post": {"s": jnp.ones((d,), dtype), "b": jnp.zeros((d,), dtype)},
        "proj": dense(next(keys), d, (d, cfg.embed_dim)),  # no bias
    }
    for _ in range(cfg.depth):
        params["blocks"].append(
            {
                "ln1_s": jnp.ones((d,), dtype),
                "ln1_b": jnp.zeros((d,), dtype),
                "qkv_w": dense(next(keys), d, (d, 3 * d)),
                "qkv_b": jnp.zeros((3 * d,), dtype),
                "proj_w": dense(next(keys), d, (d, d)),
                "proj_b": jnp.zeros((d,), dtype),
                "ln2_s": jnp.ones((d,), dtype),
                "ln2_b": jnp.zeros((d,), dtype),
                "fc1_w": dense(next(keys), d, (d, md)),
                "fc1_b": jnp.zeros((md,), dtype),
                "fc2_w": dense(next(keys), md, (md, d)),
                "fc2_b": jnp.zeros((d,), dtype),
            }
        )
    return params


def _mlp_quickgelu(x: jnp.ndarray, p: Params) -> jnp.ndarray:
    h = quick_gelu(L.linear(x, p["fc1_w"], p["fc1_b"]))
    return L.linear(h, p["fc2_w"], p["fc2_b"])


def block(p: Params, x: jnp.ndarray, cfg: CLIPVisionConfig,
          want_attn: bool = False, attn_impl=None
          ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    h, probs = attn_ops.mhsa(
        L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps),
        p, cfg.heads, want_attn=want_attn, attn_impl=attn_impl,
    )
    x = x + h
    x = x + _mlp_quickgelu(
        L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p
    )
    return x, probs


def embed(params: Params, images: jnp.ndarray, cfg: CLIPVisionConfig
          ) -> jnp.ndarray:
    images = images.astype(params["patch_embed"]["w"].dtype)
    x = L.patchify(images, cfg.patch)
    x = jnp.dot(x, params["patch_embed"]["w"],
                preferred_element_type=jnp.float32,
                precision=L.mm_precision(x, params["patch_embed"]["w"])
                ).astype(x.dtype)
    x = L.add_cls_and_pos(x, params["cls_token"], params["pos_emb"])
    return L.layer_norm(x, params["ln_pre"]["s"], params["ln_pre"]["b"],
                        cfg.ln_eps)


def project(params: Params, x: jnp.ndarray, cfg: CLIPVisionConfig,
            normalize: bool = True) -> jnp.ndarray:
    """ln_post on CLS -> bias-free projection -> (optional) L2 normalize."""
    cls = L.layer_norm(x[:, 0], params["ln_post"]["s"], params["ln_post"]["b"],
                       cfg.ln_eps)
    emb = jnp.dot(cls, params["proj"], preferred_element_type=jnp.float32,
                  precision=L.mm_precision(cls, params["proj"]))
    if normalize:
        emb = emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)
    return emb.astype(x.dtype)


def forward(params: Params, images: jnp.ndarray, cfg: CLIPVisionConfig,
            want_attn: bool = False, attn_impl=None) -> Dict[str, jnp.ndarray]:
    x = embed(params, images, cfg)
    attns: List[jnp.ndarray] = []
    for p in params["blocks"]:
        x, probs = block(p, x, cfg, want_attn=want_attn, attn_impl=attn_impl)
        if want_attn:
            attns.append(probs.astype(x.dtype))
    out = {"embedding": project(params, x, cfg)}
    if want_attn:
        out["attn"] = tuple(attns)  # per-layer, unstacked (see vit.forward)
    return out


# -- node decomposition -----------------------------------------------------------


def layer_fns(cfg: CLIPVisionConfig, attn_impl=None):
    layers: List[Tuple[str, List[str], Callable]] = []

    from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

    # OpenAI CLIP resizes the shorter side DIRECTLY to img_size (bicubic)
    # then center-crops — resize_to=img_size reproduces that framing (the
    # ImageNet default 256->224 recipe would crop away ~12.5% of the
    # frame CLIP keeps). method="bicubic" is the PIL-exact Keys a=-0.5
    # kernel in matmul form (parity-tested vs PIL and torch antialiased
    # bicubic in tests/test_clip.py).
    layers.append(("transform", [], lambda p, ins: {
        "o": preprocess_mm(ins["o"], cfg.img_size, CLIP_MEAN, CLIP_STD,
                           resize_to=cfg.img_size, method="bicubic")
    }))

    def embed_fn(p, ins):
        # unbatched [C,H,W] inputs get a batch dim; downstream stays
        # batched (the graph contract is batch-carrying end-to-end)
        x = ins["o"]
        if x.ndim == 3:
            x = x[None]
        return {"o": embed(p, x, cfg)}

    layers.append(("embed", [], embed_fn))

    def block_fn(p, ins, want=frozenset()):
        # one shared fn: unlike vit.layer_fns there is no per-index
        # behavior, the layer identity comes entirely from its captures
        y, probs = block(p, ins["o"], cfg, want_attn=bool(want),
                         attn_impl=attn_impl)
        outs = {"o": y}
        if probs is not None:
            outs["attn"] = probs
        return outs

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["attn"], block_fn))

    # the embedding-extraction node: the plugin-API generalization proof
    layers.append(("embedding", [], lambda p, ins: {
        "o": project(p, ins["o"], cfg)
    }))
    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name.startswith("blocks."):
        return params["blocks"][int(layer_name.split(".", 1)[1])]
    if layer_name == "embed":
        return {
            "patch_embed": params["patch_embed"],
            "cls_token": params["cls_token"],
            "pos_emb": params["pos_emb"],
            "ln_pre": params["ln_pre"],
        }
    if layer_name == "embedding":
        return {
            "ln_post": params["ln_post"],
            "proj": params["proj"],
        }
    return {}


def from_openai(sd: Dict[str, Any], cfg: CLIPVisionConfig,
                dtype=jnp.float32) -> Params:
    """OpenAI CLIP state dict (``visual.*`` keys, as numpy) -> our pytree."""
    import numpy as np

    def get(name):
        return np.asarray(sd[name], dtype=np.float32)

    d = cfg.width
    params: Params = {
        "patch_embed": {
            "w": jnp.asarray(get("visual.conv1.weight").reshape(d, -1).T, dtype)
        },
        "cls_token": jnp.asarray(get("visual.class_embedding").reshape(1, 1, d),
                                 dtype),
        "pos_emb": jnp.asarray(get("visual.positional_embedding")[None], dtype),
        "ln_pre": {
            "s": jnp.asarray(get("visual.ln_pre.weight"), dtype),
            "b": jnp.asarray(get("visual.ln_pre.bias"), dtype),
        },
        "blocks": [],
        "ln_post": {
            "s": jnp.asarray(get("visual.ln_post.weight"), dtype),
            "b": jnp.asarray(get("visual.ln_post.bias"), dtype),
        },
        "proj": jnp.asarray(get("visual.proj"), dtype),
    }
    for i in range(cfg.depth):
        pre = f"visual.transformer.resblocks.{i}."
        params["blocks"].append(
            {
                "ln1_s": jnp.asarray(get(pre + "ln_1.weight"), dtype),
                "ln1_b": jnp.asarray(get(pre + "ln_1.bias"), dtype),
                "qkv_w": jnp.asarray(get(pre + "attn.in_proj_weight").T, dtype),
                "qkv_b": jnp.asarray(get(pre + "attn.in_proj_bias"), dtype),
                "proj_w": jnp.asarray(get(pre + "attn.out_proj.weight").T, dtype),
                "proj_b": jnp.asarray(get(pre + "attn.out_proj.bias"), dtype),
                "ln2_s": jnp.asarray(get(pre + "ln_2.weight"), dtype),
                "ln2_b": jnp.asarray(get(pre + "ln_2.bias"), dtype),
                "fc1_w": jnp.asarray(get(pre + "mlp.c_fc.weight").T, dtype),
                "fc1_b": jnp.asarray(get(pre + "mlp.c_fc.bias"), dtype),
                "fc2_w": jnp.asarray(get(pre + "mlp.c_proj.weight").T, dtype),
                "fc2_b": jnp.asarray(get(pre + "mlp.c_proj.bias"), dtype),
            }
        )
    return params
