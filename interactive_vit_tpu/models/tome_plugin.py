"""ToMe-ViT plugin — token-merging acceleration as tappable graph nodes.

Registers ``vit_b16_tome:<layer>`` node kinds. Block nodes extend the
vit chain contract with the ToMe channels: sizes (``s``) and the
original-token assignment (``a``) flow between blocks — the generated
graph JSON wires them alongside ``o`` — and every block can tap
``merge``, a color patch-map of which original patches have merged into
each surviving token. The reference's tap-anything contract
(``/root/reference/main/context.py:79-88``) extended to the model's own
token coarsening.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax

from interactive_vit_tpu.models import tome
from interactive_vit_tpu.models.model_plugin import JaxModel, LayerNodeKind


class ToMeBlockKind(LayerNodeKind):
    """Block node accepting the optional flowing ToMe channels."""

    OPTIONAL_INS = ("s", "a", "r")

    def io(self, params):
        return {"ins": ["o", "s", "a", "r"], "outs": ["o"] + self._extra}

    @property
    def optional_inputs(self):
        return frozenset(self.OPTIONAL_INS)


class ToMeModel(JaxModel):
    """JaxModel whose generated graph wires ``s``/``a`` along the chain."""

    def _kind_cls(self, layer_name: str) -> type:
        return (ToMeBlockKind if layer_name.startswith("blocks.")
                else LayerNodeKind)

    def generate_graph_json(self) -> Dict:
        obj = super().generate_graph_json()
        blocks = [i for i, n in enumerate(obj["nodes"])
                  if ":blocks." in n["instance"].get("endpoint", "")]
        for a, b in zip(blocks, blocks[1:]):
            for ch in ("s", "a"):
                obj["edges"].append(
                    {"in_port": {"node": a, "channel": ch},
                     "out_port": {"node": b, "channel": ch}})
        return obj


def make_tome_model(
    variant: str = "vit_b16_tome",
    params: Optional[Any] = None,
    seed: int = 0,
    dtype=None,
    r: Optional[int] = None,
    with_categories: bool = True,
) -> JaxModel:
    """Build a registerable ToMe-ViT.

    ``params`` takes any plain-vit pytree of the same geometry (the whole
    point: post-hoc acceleration of an existing checkpoint); ``r``
    overrides the variant's merge rate. Attention runs the plain path
    (proportional attention needs a per-key bias), which is
    differentiable as-is.
    """
    import dataclasses

    import jax.numpy as jnp

    cfg = tome.VARIANTS[variant]
    if r is not None:
        cfg = dataclasses.replace(cfg, r=r)
    if params is None:
        params = tome.init_params(jax.random.key(seed), cfg,
                                  dtype=dtype or jnp.float32)
    cats = None
    if with_categories and cfg.num_classes == 1000:
        from interactive_vit_tpu.models.labels import class_names

        cats = class_names(1000)
    n_last = cfg.n_tokens(cfg.depth)
    descriptions = {
        "transform": f"Resize+CenterCrop({cfg.img_size})+Normalize",
        "embed": f"PatchEmbed p={cfg.patch} d={cfg.width} + CLS + pos "
                 f"[B,{cfg.tokens},{cfg.width}]",
        "norm": "final LayerNorm",
        "head": f"Linear({cfg.width} -> {cfg.num_classes}) "
                f"on {n_last} surviving tokens",
        **{
            f"blocks.{i}": (
                f"ToMe block d={cfg.width} h={cfg.heads}: "
                f"{cfg.n_tokens(i)} -> {cfg.n_tokens(i + 1)} tokens "
                f"(tap 'merge' for the patch-merge map)")
            for i in range(cfg.depth)
        },
    }
    return ToMeModel(
        name=cfg.name,
        layers=tome.layer_fns(cfg),
        params=params,
        layer_params_fn=tome.layer_params,
        descriptions=descriptions,
        category_names=cats,
    )


def instances():
    """Plugin-contract entry point."""
    return [make_tome_model()]
