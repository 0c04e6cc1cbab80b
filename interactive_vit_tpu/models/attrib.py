"""Chefer-style generic attention attribution as a servable graph node.

Implements "Generic Attention-model Explainability for Interpreting
Bi-Modal and Encoder-Decoder Transformers" (Chefer, Gur & Wolf, 2021) for
the plain-ViT family tree (vit / deit / dino / dinov2): per-block
relevance updates ``R += E_h[(∇A ⊙ A)⁺] · R`` starting from the identity,
where ``A`` is each block's post-softmax attention and ``∇A`` is the
gradient of the target class logit with respect to it. The CLS row of the
final ``R`` is the class-specific patch heatmap — a strictly stronger
explanation than plain attention rollout (which is class-agnostic and
provably blind to negative heads).

Mechanics — all per-block attention gradients come from ONE
backward pass: the trunk is re-traced with a zero "delta" injected
additively into every block's post-softmax probabilities, and
``jax.grad`` with respect to the delta tuple is exactly
``(∂ logit/∂A_l)_l`` (each delta stands in for its block's attention
matrix at the true evaluation point, so the derivative is the standard
intermediate gradient). Forward + backward + the relevance chain fuse
into the SAME jitted program as the rest of the graph — device matmuls
end to end, no host round trip. The reference could not express any of this:
its server evaluated under ``torch.no_grad()``
(``/root/reference/main/context.py:79-88``).

Numerics: the injected attention mirrors ``ops.attention.attention_reference``
line for line (f32 softmax, ``mm_precision`` policy, probs cast to the
value dtype for the PV matmul) so the attribution trunk serves the same
logits as the block chain. The relevance-chain matmul precision is keyed
on the model's activation dtype, matching ``rollout_step``'s policy.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.graph.registry import NodeKind
from interactive_vit_tpu.models import vit
from interactive_vit_tpu.ops.layers import mm_precision, precision_for

Params = Dict[str, Any]


def _make_inject_impl(delta: jnp.ndarray, store: List[jnp.ndarray]):
    """An ``attn_impl`` (the ``ops.attention.mhsa`` contract) that adds
    ``delta`` to the post-softmax probabilities and records them.

    ``delta`` is zeros at the evaluation point — the forward value is
    unchanged and the gradient w.r.t. ``delta`` is the true intermediate
    gradient ∂target/∂probs of this block.

    PLAIN-ViT ONLY: this impl deliberately omits ``attention_reference``'s
    ``key_bias`` (ToMe size-bias) and ``causal`` (CLIP text) paths —
    reusing it for those trunks would produce plausible-looking but wrong
    logits/attribution. ``AttribNodeKind.__init__`` enforces this with a
    config-type check (advisor r3)."""

    def impl(q, k, v, want_attn=False, n_real=None):
        del want_attn  # probs are recorded unconditionally via `store`
        dh = q.shape[-1]
        scale = 1.0 / math.sqrt(dh)
        logits = jnp.einsum(
            "bhnd,bhmd->bhnm", q, k, preferred_element_type=jnp.float32,
            precision=mm_precision(q, k),
        ) * scale
        if n_real is not None and n_real < q.shape[2]:
            neg = -0.7 * jnp.finfo(jnp.float32).max
            col = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 3)
            logits = jnp.where(col < n_real, logits, neg)
        probs = jax.nn.softmax(logits, axis=-1) + delta
        store.append(probs)
        out = jnp.einsum(
            "bhnm,bhmd->bhnd", probs.astype(v.dtype), v,
            preferred_element_type=jnp.float32,
            precision=mm_precision(v),
        ).astype(v.dtype)
        return out, None

    return impl


def trunk_with_attn_grads(
    caps: Params,
    tokens: jnp.ndarray,
    cfg: vit.ViTConfig,
    scalar_fn,
    qkv_head_major: bool = False,
) -> Tuple[Tuple[jnp.ndarray, ...], Tuple[jnp.ndarray, ...], jnp.ndarray]:
    """Run the block trunk from post-embed tokens; return per-block
    ``(probs, grads, logits)`` with grads = ∂ scalar_fn(logits) / ∂ probs.

    ``caps``: ``{"blocks": [...], "norm": ..., "head": ...}`` — the same
    subtrees ``vit.layer_params`` hands the chained nodes, so the
    attribution trunk cannot drift from the served math. One forward and
    one backward regardless of depth (the delta-injection construction in
    the module docstring)."""
    blocks = caps["blocks"]
    b, n, _d = tokens.shape

    def f(deltas):
        store: List[jnp.ndarray] = []
        x = tokens
        for p, dl in zip(blocks, deltas):
            x, _probs, _mean = vit.block(
                p, x, cfg, want_attn=False,
                attn_impl=_make_inject_impl(dl, store),
                qkv_head_major=qkv_head_major,
            )
        feats = vit.final_norm(
            {"norm": caps["norm"]}, x[:, : cfg.prefix_tokens], cfg)
        logits = vit.head(caps, feats)
        return scalar_fn(logits), (tuple(store), logits)

    zeros = tuple(
        jnp.zeros((b, cfg.heads, n, n), jnp.float32) for _ in blocks)
    grads, (probs, logits) = jax.grad(f, has_aux=True)(zeros)
    return probs, grads, logits


def chefer_relevance(probs, grads, act_dtype) -> jnp.ndarray:
    """Fold per-block (probs, grads) into the relevance matrix [B,N,N].

    ``R = I; for each block: R += E_h[(∇A ⊙ A)⁺] · R`` — the Chefer
    update. Accumulates f32; the chain matmul precision is keyed on the
    model's activation dtype (``rollout_step``'s policy — see module
    docstring)."""
    b, _h, n, _ = probs[0].shape
    prec = precision_for(act_dtype)
    r = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (b, n, n))
    for a, g in zip(probs, grads):
        abar = jnp.mean(jax.nn.relu(g * a), axis=1)  # [B, N, N] f32
        r = r + jnp.einsum("bij,bjk->bik", abar, r, precision=prec)
    return r


def _render_grid(rel_row: jnp.ndarray) -> jnp.ndarray:
    """[B, P] per-patch relevance -> [B, 3, g, g] heatmap for img_view.

    Per-sample max-normalized (relevance is nonnegative by construction:
    identity + sums of ReLU'd products)."""
    b, p = rel_row.shape
    g = int(math.isqrt(p))
    if g * g != p:
        raise ValueError(
            f"{p} patch tokens do not tile a square grid — wire the "
            f"attrib node from the model's embed output")
    h = rel_row / jnp.maximum(
        jnp.max(rel_row, axis=-1, keepdims=True), 1e-12)
    h = h.reshape(b, 1, g, g)
    return jnp.broadcast_to(h, (b, 3, g, g))


class AttribNodeKind(NodeKind):
    """``<variant>:attrib`` — class-specific attention attribution node.

    Wiring: input "o" = the model's ``:embed`` output (the post-embedding
    token stream [B,N,D] — the trunk re-runs from there inside this
    node). Outputs: "o" = [B,3,g,g] patch-grid heatmap of the CLS row's
    relevance (wire into ``img_view``/``overlay``); "rel" = the raw
    [B,N,N] relevance matrix (extra channel — ships only when wired or
    tapped); "logits" = the attribution trunk's own logits (extra;
    numerically ≈ the chain's head output — a live parity probe).

    Params (stringly, wire contract ``/root/reference/main/graph.py:7-10``):
      target  max | class   the explained scalar (per-sample, summed over
                            the batch — samples independent)
      class   int           class index for target=class. DYNAMIC:
                            scrubbing classes re-keys the cached program —
                            no recompile (captures reference the plugin's
                            param tree, so the per-value capture cache
                            costs one int per class, not a weight copy).

    Memory: the backward materializes L×[B,H,N,N] f32 probs + grads
    (ViT-B @224: ~45 MB at batch 1) — sized for interactive use, not
    batched offline runs.
    """

    def __init__(self, model, cfg: vit.ViTConfig, quantized: bool = False,
                 tp_layout: bool = False):
        # plain-ViT trunks only: _make_inject_impl has no key_bias (ToMe)
        # or causal (CLIP text) path, so a subclassed config (e.g.
        # ToMeViTConfig) would attribute against the WRONG forward math
        # with matching shapes. Fail loudly at construction instead.
        if type(cfg) is not vit.ViTConfig:
            raise TypeError(
                f"AttribNodeKind supports plain ViT trunks only; got "
                f"{type(cfg).__name__} for {model.name} (the injection "
                f"attn_impl omits ToMe key-bias and causal paths)")
        super().__init__(model.prefix() + "attrib")
        self.model = model
        self.cfg = cfg
        self._quantized = quantized
        self._tp_layout = tp_layout

    TARGETS = ("max", "class")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "rel", "logits"]}

    def extra_outs(self, params):
        return ["rel", "logits"]

    def dynamic_params(self):
        return frozenset({"class"})

    def dynamic_capture_keys(self):
        return frozenset({"class"})

    def contents(self, params):
        import html as _html

        target = params.get("target", "max")
        opts = "".join(
            f"<option value=\"{o}\"{' selected' if o == target else ''}>"
            f"{o}</option>" for o in self.TARGETS)
        cls = _html.escape(str(int(float(params.get("class", 0)))))
        return ("<p>attention attribution (Chefer 2021)</p>"
                "<p>wire from the embed node; CLS-row relevance "
                "heatmap</p>"
                f"<label>target <select data-param=\"target\">{opts}"
                "</select></label> "
                f"<label>class <input data-param=\"class\" type=\"number\""
                f" step=\"1\" value=\"{cls}\" size=\"6\"></label>")

    def captures(self, params):
        p = self.model.params
        trunk = {"blocks": p["blocks"], "norm": p["norm"],
                 "head": p["head"]}
        if "head_dist" in p:  # DeiT distilled: averaged dual heads
            trunk["head_dist"] = p["head_dist"]
        return {"trunk": trunk,
                "class": np.int32(int(float(params.get("class", 0))))}

    def _decode(self, params) -> str:
        target = params.get("target", "max")
        if target not in self.TARGETS:
            raise ValueError(
                f"target must be one of {self.TARGETS}, got {target!r}")
        return target

    def fn(self, params):
        target = self._decode(params)
        cfg, head_major = self.cfg, self._tp_layout
        quantized = self._quantized

        def run(ins, caps):
            trunk = caps["trunk"]
            if quantized:
                # the trunk differentiates: int8 leaf-dicts dequantize
                # inline, same policy as the saliency grad twins
                # (model_plugin.dequant_grad_twin)
                from interactive_vit_tpu.models.model_plugin import (
                    dequant_grad_twin,
                )
                trunk = dequant_grad_twin(lambda p, _ins: p)(trunk, None)
            x = ins["o"]
            if x.ndim == 2:  # unbatched token stream
                x = x[None]
            if x.ndim != 3:
                raise ValueError(
                    f"attrib expects the embed node's [B,N,D] token "
                    f"stream, got shape {x.shape}")

            def scalar(logits):
                y = logits.astype(jnp.float32)
                if target == "class":
                    c = jnp.clip(caps["class"], 0, y.shape[-1] - 1)
                    y = jnp.take(y, c, axis=-1)
                else:
                    y = jnp.max(y, axis=-1)
                return jnp.sum(y)

            probs, grads, logits = trunk_with_attn_grads(
                trunk, x, cfg, scalar, qkv_head_major=head_major)
            rel = chefer_relevance(probs, grads, x.dtype)
            # CLS row, prefix columns dropped (DeiT: CLS + DIST)
            row = rel[:, 0, cfg.prefix_tokens:]
            return {"o": _render_grid(row).astype(x.dtype),
                    "rel": rel, "logits": logits}

        return run
