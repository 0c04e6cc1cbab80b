"""The ONE variant -> model-maker dispatch.

Serving (``serving/server.py``), the headless runner (``tools/run_graph``)
and the AOT exporter (``tools/export_graph``) all need "give me the
registerable JaxModel for this variant name" — keeping three copies of
the mapping is how the runner silently fell behind the server's model
list (resnet50 / MoE / CLIP-text / ToMe were server-only for a while).

Mirrors the reference's model zoo discovery (plugins publish
``instances()``, ``/root/reference/main/context.py:154-176``) — ours is
keyed by variant name because one maker parameterizes a whole family.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

logger = logging.getLogger(__name__)


def known_variants() -> list:
    """Every variant name ``make_model`` accepts (sorted)."""
    from interactive_vit_tpu.models import convnext, mae, moe, swin, tome, vit

    return sorted(
        set(vit.VARIANTS) | set(moe.VARIANTS) | set(tome.VARIANTS)
        | set(swin.VARIANTS) | set(convnext.VARIANTS) | set(mae.VARIANTS)
        | {"clip_b32", "clip_text_b32", "vgg16", "resnet50"})


def _family_maker(variant: str):
    """Non-plain-ViT family maker as ``fn(params, seed, dtype, attn_impl)
    -> JaxModel``, or None when ``variant`` is (or should be) a
    plain-ViT name. ONE membership decision: a variant is non-ViT exactly
    when this returns a maker, so the quantize warning below cannot
    desynchronize from the dispatch."""
    if variant == "clip_b32":
        from interactive_vit_tpu.models.clip_plugin import make_clip_model

        return lambda params, seed, dtype, attn_impl: (
            make_clip_model(params=params, seed=seed, attn_impl=attn_impl,
                            dtype=dtype))
    if variant == "vgg16":
        from interactive_vit_tpu.models.vgg_plugin import make_vgg16_model

        return lambda params, seed, dtype, attn_impl: (
            make_vgg16_model(params=params, seed=seed, dtype=dtype))
    if variant == "clip_text_b32":
        from interactive_vit_tpu.models.clip_text_plugin import (
            make_clip_text_model,
        )

        return lambda params, seed, dtype, attn_impl: (
            make_clip_text_model(params=params, seed=seed, dtype=dtype))
    if variant == "resnet50":
        from interactive_vit_tpu.models.resnet_plugin import (
            make_resnet50_model,
        )

        return lambda params, seed, dtype, attn_impl: (
            make_resnet50_model(params=params, seed=seed, dtype=dtype))
    if variant.startswith("convnext_"):
        from interactive_vit_tpu.models.convnext_plugin import (
            make_convnext_model,
        )

        return lambda params, seed, dtype, attn_impl: (
            make_convnext_model(variant, params=params, seed=seed,
                                dtype=dtype))
    if variant.startswith("swin_"):
        from interactive_vit_tpu.models.swin_plugin import make_swin_model

        return lambda params, seed, dtype, attn_impl: (
            make_swin_model(variant, params=params, seed=seed, dtype=dtype))
    if variant.startswith("vit_moe"):
        from interactive_vit_tpu.models.moe_plugin import make_moe_model

        return lambda params, seed, dtype, attn_impl: (
            make_moe_model(variant, params=params, seed=seed, dtype=dtype,
                           attn_impl=attn_impl))
    if variant.startswith("mae_"):
        from interactive_vit_tpu.models.mae_plugin import make_mae_model

        return lambda params, seed, dtype, attn_impl: (
            make_mae_model(variant, params=params, seed=seed, dtype=dtype))
    if "_tome" in variant:
        from interactive_vit_tpu.models.tome_plugin import make_tome_model

        # any plain-vit checkpoint of the same geometry loads: token
        # merging is post-hoc (models/tome.py)
        return lambda params, seed, dtype, attn_impl: (
            make_tome_model(variant, params=params, seed=seed, dtype=dtype))
    return None


def make_model(
    variant: str,
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=None,
    attn_impl=None,
    quantize=False,
    tp_layout: bool = False,
):
    """Build the registerable ``JaxModel`` for ``variant``.

    ``quantize`` is wired for the plain-ViT and Swin families; other
    families log a warning and serve their float dtype."""
    base = variant.partition("@")[0]
    if ("@" in variant and _family_maker(base) is not None
            and not base.startswith("mae_")):
        # MAE is exempt: its encoder name resolves through the plain-ViT
        # grammar, so mae_t16@64 is a valid derived geometry
        raise ValueError(
            f"{variant!r}: the @[<pixels>][p<patch>] suffix is supported "
            f"only for the plain-ViT family (vit_*/dino_*/deit_*) — "
            f"{base}'s stage/pooling geometry is resolution-specific")
    maker = _family_maker(variant)
    if maker is not None:
        if variant.startswith("swin_"):
            # swin carries the quantize contract (models/swin_plugin.py)
            # — handled here rather than through the 4-arg maker surface
            from interactive_vit_tpu.models.swin_plugin import (
                make_swin_model,
            )

            return make_swin_model(variant, params=params, seed=seed,
                                   dtype=dtype, quantize=quantize)
        if quantize:
            logger.warning("int8 not wired for %s; serving bf16", variant)
        return maker(params, seed, dtype, attn_impl)

    from interactive_vit_tpu.models import vit

    if base not in vit.VARIANTS:
        raise ValueError(
            f"unknown model variant {variant!r}; known: "
            f"{known_variants()} (plain-ViT names also accept a "
            f"@[<pixels>][p<patch>] suffix, e.g. dino_s16@448 or "
            f"vit_b16@p8)")
    from interactive_vit_tpu.models.vit_plugin import make_vit_model

    return make_vit_model(variant, params=params, seed=seed,
                          attn_impl=attn_impl, dtype=dtype,
                          quantize=quantize, tp_layout=tp_layout)
