"""ViT model plugins: factory wiring ViT variants into the graph registry.

Analog of the reference's VGG16 plugin (``/root/reference/static/models/
vgg16.py``), which exploded the model into 42 tappable nodes and appended a
category sink. Here each ViT variant becomes ``depth + 4`` nodes:

    <name>:transform   eval preprocessing (resize/crop/normalize)
    <name>:embed       patchify + patch-embed matmul + CLS + pos
    <name>:blocks.i    transformer block, extra tap channel "attn"
    <name>:norm        final LayerNorm
    <name>:head        classifier on the CLS token
"""

from __future__ import annotations

from typing import Any, Optional

import jax

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.models.model_plugin import JaxModel


def make_vit_model(
    variant: str = "vit_t16",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=None,
    attn_impl=None,
    with_categories: bool = True,
    quantize: bool = False,
    tp_layout: bool = False,
) -> JaxModel:
    """Build a registerable ``JaxModel`` for a ViT variant.

    ``params=None`` -> deterministic random init (no pretrained download in
    this environment; use ``models/weights.py`` converters to load real
    checkpoints). ``attn_impl`` is the attention implementation
    (``ops/dispatch.default_attn_impl``; None = the plain path).

    ``quantize=True`` (or ``"w8"``) -> weight-only int8 (``ops/quant.py``):
    linear weights stored int8 per-channel, dequantized inside the matmuls;
    halves the weight streaming that dominates small-batch interactive
    latency. ``quantize="w8a8"`` additionally quantizes activations
    per-token at runtime so fc1/fc2 run int8 x int8 -> int32 dots — a
    stronger accuracy perturbation, strictly opt-in.
    """
    import jax.numpy as jnp

    cfg = vit.resolve_variant(variant)
    if params is None:
        params = vit.init_params(
            jax.random.key(seed), cfg, dtype=dtype or jnp.float32
        )
    else:
        # "@res"/"@p" serving: a native-geometry checkpoint loads at any
        # derived resolution/patch size (pos-table resample + FlexiViT
        # PI-resize of the patch kernel)
        params = vit.adapt_checkpoint(params, cfg)
    if tp_layout:
        # mesh TP serving: head-major qkv columns so the "model"-axis
        # column sharding is head-aligned (parallel/mesh.py docstring)
        from interactive_vit_tpu.parallel.mesh import permute_qkv_head_major

        params = permute_qkv_head_major(params, cfg.heads)
    if quantize:
        from interactive_vit_tpu.ops.quant import quantize_tree

        mode = quantize if isinstance(quantize, str) else "w8"
        if mode == "w8a8":
            # fc1/fc2 only: the MLP holds two thirds of the block's
            # matmul FLOPs; the attention linears stay dense
            params = quantize_tree(
                params, names=frozenset({"fc1_w", "fc2_w"}), mode=mode)
        else:
            params = quantize_tree(params, mode=mode)
    layers = vit.layer_fns(cfg, attn_impl=attn_impl,
                           qkv_head_major=tp_layout)
    # differentiable twins for gradient replays (saliency/dream jax.grad
    # through the blocks): Pallas kernels have no AD rule and quantized
    # matmuls round (zero gradient a.e.), so the replay re-traces the
    # plain dense math — with quant-dict weights dequantized inline
    grad_layers = None
    if attn_impl is not None or quantize:
        from interactive_vit_tpu.models.model_plugin import dequant_grad_twin

        twins = vit.layer_fns(cfg, qkv_head_major=tp_layout)
        grad_layers = {ln: (dequant_grad_twin(f) if quantize else f)
                       for ln, _extra, f in twins}
    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+Normalize",
        "embed": f"PatchEmbed p={cfg.patch} d={cfg.width} + CLS + pos",
        "norm": "LayerNorm",
        "head": (f"Linear({cfg.width} -> {cfg.num_classes})"
                 if cfg.num_classes else
                 f"CLS features [{cfg.width}] (self-supervised: "
                 f"no classifier)"),
        **{
            f"blocks.{i}": f"TransformerBlock d={cfg.width} h={cfg.heads}"
            for i in range(cfg.depth)
        },
    }
    from interactive_vit_tpu.models.labels import class_names

    cats = (class_names(cfg.num_classes)
            if with_categories and cfg.num_classes else None)
    model = JaxModel(
        name=variant,
        layers=layers,
        params=params,
        layer_params_fn=vit.layer_params,
        descriptions=descriptions,
        category_names=cats,
        # every block runs the same computation over its own captures, so
        # untapped block chains are pipeline-foldable (executor PP mode)
        fold_groups={f"blocks.{i}": f"{variant}:block"
                     for i in range(cfg.depth)},
        grad_layers=grad_layers,
    )
    # Chefer attention attribution (models/attrib.py): class-specific
    # grad x attention relevance over the whole trunk, one node. The
    # node re-traces the blocks in pure XLA under jax.grad, so it works
    # for every serving path (attention kernels, quantized weights, TP
    # layout) via its own differentiable trunk.
    from interactive_vit_tpu.models.attrib import AttribNodeKind

    model.extra_kinds.append(
        AttribNodeKind(model, cfg, quantized=bool(quantize),
                       tp_layout=tp_layout))
    return model


def instances():
    """Plugin-contract entry point: the default served models.

    ViT-Tiny only here (cheap to init at import, parity with the reference
    registering one model at import time); the serving app registers bigger
    variants explicitly from its config.
    """
    return [make_vit_model("vit_t16")]
