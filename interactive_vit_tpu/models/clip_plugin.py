"""CLIP ViT-B/32 image-encoder plugin (embedding-extraction node path)."""

from __future__ import annotations

from typing import Any, Optional

import jax

from interactive_vit_tpu.models import clip
from interactive_vit_tpu.models.model_plugin import JaxModel


def make_clip_model(params: Optional[Any] = None, seed: int = 0,
                    dtype=None, attn_impl=None, cfg=None) -> JaxModel:
    import jax.numpy as jnp

    cfg = cfg or clip.CLIPVisionConfig()
    if params is None:
        params = clip.init_params(jax.random.key(seed), cfg,
                                  dtype=dtype or jnp.float32)

    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+CLIP-Normalize",
        "embed": f"PatchEmbed p={cfg.patch} + CLS + pos + ln_pre",
        "embedding": f"ln_post + proj -> L2-normed [{cfg.embed_dim}]",
        **{
            f"blocks.{i}": f"CLIPBlock d={cfg.width} h={cfg.heads} (QuickGELU)"
            for i in range(cfg.depth)
        },
    }
    # differentiable twins for gradient replays: Pallas kernels have no
    # AD rule
    grad_layers = None
    if attn_impl is not None:
        grad_layers = {ln: f for ln, _extra, f in clip.layer_fns(cfg)}
    return JaxModel(
        name=cfg.name,
        layers=clip.layer_fns(cfg, attn_impl=attn_impl),
        params=params,
        layer_params_fn=clip.layer_params,
        descriptions=descriptions,
        category_names=None,  # embedding path: no category sink
        grad_layers=grad_layers,
    )


def instances():
    return [make_clip_model()]
