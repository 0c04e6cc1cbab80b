"""Swin plugin — registers the hierarchical windowed-attention surface.

20 nodes for swin_t: transform, patch_embed, stages.{s}.{b} (window
attention maps on the "attn" channel), merge.{s}, norm, pool, head +
the category sink in the generated graph (the reference's generic
model-explosion contract, ``/root/reference/main/context.py:38-47``).

No fold groups: adjacent blocks ALTERNATE shifted/unshifted windows, so
a chain of same-stage blocks is not a uniform computation over captures
(the GPipe fold precondition). Grad twins register for quantized
weights (round() has zero gradient); the window path is differentiable
as-is.
"""

from __future__ import annotations

from typing import Any, Optional

import jax

from interactive_vit_tpu.models import swin
from interactive_vit_tpu.models.model_plugin import JaxModel, LayerNodeKind


class _SwinBlockKind(LayerNodeKind):
    """Swin block node: the generic attn_heads control plus a window
    selector (attn_win collapses the [B,nW,h,T,T] tap to [B,h,T,T] — the
    rank the client's head-grid renderer already draws)."""

    def contents(self, params):
        import html as _html

        cur = params.get("attn_win", "")
        return super().contents(params) + (
            f" <label>tap window <input data-param=\"attn_win\" "
            f"type=\"text\" size=\"4\" value=\"{_html.escape(cur)}\" "
            f"placeholder=\"all\"></label>")


class SwinJaxModel(JaxModel):
    def _kind_cls(self, layer_name: str) -> type:
        return (_SwinBlockKind if layer_name.startswith("stages.")
                else LayerNodeKind)


def make_swin_model(
    variant: str = "swin_t",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=None,
    cfg: Optional[swin.SwinConfig] = None,
    with_categories: bool = True,
    quantize=False,
) -> JaxModel:
    """Build a registerable ``JaxModel`` for a Swin variant.

    ``cfg`` overrides the variant table (tests use tiny geometries);
    ``params=None`` -> deterministic random init (zero-egress image;
    ``swin.from_torch`` loads real torchvision checkpoints, also via
    serving ``--ckpt``).

    ``quantize``: same contract as the ViT maker — ``True``/``"w8"`` =
    weight-only int8 (every linear), ``"w8a8"`` = fc1/fc2 int8 weights +
    dynamic per-token activation quantization (int8 x int8 -> int32
    dots). Opt-in accuracy class, ``--dtype int8w8a8``."""
    import jax.numpy as jnp

    cfg = cfg or swin.VARIANTS[variant]
    if params is None:
        params = swin.init_params(jax.random.key(seed), cfg,
                                  dtype=dtype or jnp.float32)
    grad_layers = None
    if quantize:
        from interactive_vit_tpu.ops.quant import BLOCK_WEIGHTS, quantize_tree

        mode = "w8a8" if quantize == "w8a8" else "w8"
        names = (frozenset({"fc1_w", "fc2_w"}) if mode == "w8a8"
                 else BLOCK_WEIGHTS)
        params = quantize_tree(params, names=names, mode=mode)
        # differentiable twins for gradient replays (saliency/dream):
        # round() has zero gradient, so replays re-trace the plain path
        # with inline dequantization (CLAUDE.md conventions)
        from interactive_vit_tpu.models.model_plugin import dequant_grad_twin

        grad_layers = {ln: dequant_grad_twin(f)
                       for ln, _extra, f in swin.layer_fns(cfg)}
    descriptions = {
        "transform": (f"Resize({int(cfg.img_size * 232 / 224)}, bicubic)"
                      f"+CenterCrop({cfg.img_size})+Normalize"),
        "patch_embed": (f"PatchEmbed p={cfg.patch} d={cfg.embed_dim} "
                        f"+ LayerNorm"),
        "norm": "LayerNorm",
        "pool": "global average pool",
        "head": (f"Linear({cfg.stage_dim(len(cfg.depths) - 1)} "
                 f"-> {cfg.num_classes})"),
    }
    for s, depth in enumerate(cfg.depths):
        res = cfg.stage_res(s)
        for b in range(depth):
            shift = cfg.stage_shift(s, b)
            descriptions[f"stages.{s}.{b}"] = (
                f"SwinBlock {res}x{res} d={cfg.stage_dim(s)} "
                f"h={cfg.heads[s]} win={cfg.window}"
                + (f" shift={shift}" if shift else ""))
        if s + 1 < len(cfg.depths):
            descriptions[f"merge.{s}"] = (
                f"PatchMerging {res}x{res} -> {res // 2}x{res // 2}, "
                f"{cfg.stage_dim(s)} -> {cfg.stage_dim(s + 1)}")
    from interactive_vit_tpu.models.labels import class_names

    cats = (class_names(cfg.num_classes)
            if with_categories and cfg.num_classes else None)
    return SwinJaxModel(
        name=variant if cfg.name == variant else cfg.name,
        layers=swin.layer_fns(cfg),
        params=params,
        layer_params_fn=swin.layer_params,
        descriptions=descriptions,
        category_names=cats,
        grad_layers=grad_layers,
    )


def instances():
    """Plugin-contract entry point (random-init; serving boots register
    explicitly with --ckpt weights)."""
    return [make_swin_model("swin_t")]
