"""ToMe-ViT — token-merging acceleration as a servable model family.

Plain ViT trunk (IDENTICAL params/pytree to ``models/vit.py`` — any
vit checkpoint, converter, or trained state loads unchanged) that merges
the ``r`` most-similar token pairs after every block's attention
(``ops/tome_ops``), so block ``i`` runs its MLP on ``N - r·(i+1)``
tokens. Post-hoc: no retraining, the speed/fidelity trade is a serving
flag. No reference analog (fixed torch modules on CPU,
``/root/reference/main/context.py:79-88``).

The shrinking token ladder is fully static (every shape a trace-time
constant). Attention runs the plain path with ToMe's ``key_bias`` logit
term (``ops/attention.attention_reference``).

Graph surface (the interactive contract, extended):

* token sizes flow BETWEEN block nodes on an ``s`` channel ([B, N_i]
  f32) the generated graph wires along the chain — unwired, a block
  assumes unmerged inputs (ones);
* the cumulative original-token -> current-token assignment flows on an
  ``a`` channel ([B, N0] int32);
* each block can tap ``merge``: the assignment rendered as a color
  patch map ([B,3,g,g] — patches sharing a color have been merged into
  one token) — watch the model coarsen its own tokenization layer by
  layer;
* ``attn`` taps are the block's pre-merge maps ([B, H, N_i, N_i]);
* the rollout ``r`` channel stays supported ACROSS merges: the carry
  generalizes to [B, N_cur, N_tap0] and merged rows combine
  size-weighted via the same ``apply_merge`` the tokens use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.ops import attention as attn_ops
from interactive_vit_tpu.ops import layers as L
from interactive_vit_tpu.ops import tome_ops

Params = Any


@dataclasses.dataclass(frozen=True)
class ToMeViTConfig(vit.ViTConfig):
    """ViT config + ``r``: token pairs merged after each block's
    attention (clamped per-block by ``tome_ops.merge_counts``)."""

    r: int = 8

    def n_tokens(self, i: int) -> int:
        """Token count ENTERING block ``i`` (0-based)."""
        n = self.tokens
        for _ in range(i):
            n -= tome_ops.merge_counts(n, self.r)
        return n


VARIANTS: Dict[str, ToMeViTConfig] = {
    # ViT-B/16 trunk: N walks 197 -> 109 over 12 blocks (r=8) or
    # 197 -> 66 (r=16, the paper's aggressive point; later blocks clamp)
    "vit_b16_tome": ToMeViTConfig("vit_b16_tome", 224, 16, 768, 12, 12,
                                  r=8),
    "vit_b16_tome16": ToMeViTConfig("vit_b16_tome16", 224, 16, 768, 12,
                                    12, r=16),
    "vit_s16_tome": ToMeViTConfig("vit_s16_tome", 224, 16, 384, 12, 6,
                                  r=8),
}


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: ToMeViTConfig,
                dtype=jnp.float32) -> Params:
    """Identical pytree to ``vit.init_params`` — merging has no weights."""
    return vit.init_params(key, cfg, dtype=dtype)


def block(
    p: Params,
    x: jnp.ndarray,
    s: Optional[jnp.ndarray],
    cfg: ToMeViTConfig,
    want_attn: bool = False,
    want_mean: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
           Optional[jnp.ndarray], Optional[jnp.ndarray]]:
    """One ToMe block: proportional attention -> merge -> MLP.

    ``s`` [B, N] f32 token sizes (None = unmerged). Returns
    ``(y [B,N-r,D], s_new [B,N-r], lut [B,N], probs, pmean)`` — probs and
    pmean are PRE-merge attention maps over this block's input tokens.
    """
    b, n, d = x.shape
    if s is None:
        s = jnp.ones((b, n), jnp.float32)
    kb = jnp.log(jnp.maximum(s, 1e-6))
    xa = L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    q, k, v = attn_ops.qkv_proj(xa, p, cfg.heads)
    out, probs = attn_ops.attention_reference(
        q, k, v, want_attn=want_attn or want_mean, key_bias=kb)
    out = out.transpose(0, 2, 1, 3).reshape(b, n, d)
    x = x + L.linear(out, p["proj_w"], p["proj_b"])
    pmean = None
    if want_mean and probs is not None:
        pmean = probs.astype(jnp.float32).mean(axis=1).astype(x.dtype)
    if not want_attn:
        probs = None
    # the published metric: head-meaned attention keys
    metric = k.astype(jnp.float32).mean(axis=1)      # [B, N, Dh]
    lut, n_new = tome_ops.bipartite_matching(metric, cfg.r)
    if n_new != n:
        x, s = tome_ops.apply_merge(x, s, lut, n_new)
    x = x + L.mlp(L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    return x, s, lut, probs, pmean


def forward(
    params: Params,
    images: jnp.ndarray,
    cfg: ToMeViTConfig,
    want_attn: bool = False,
) -> Dict[str, Any]:
    """Monolithic forward (bench path): logits + optional ragged taps.

    ``want_attn`` adds "attn" (tuple of per-layer [B,H,N_i,N_i] maps —
    ragged across layers, so a tuple by necessity, not just economy) and
    "rollout" ([B, N_last, N0]: surviving tokens' cumulative attribution
    to the ORIGINAL tokens; merged rows fold size-weighted).
    """
    x = vit.embed(params, images, cfg)
    b, n0 = x.shape[0], x.shape[1]
    s = jnp.ones((b, n0), jnp.float32)
    attns: List[jnp.ndarray] = []
    rollout = (jnp.broadcast_to(jnp.eye(n0, dtype=jnp.float32),
                                (b, n0, n0)) if want_attn else None)
    for p in params["blocks"]:
        n_in, s_prev = x.shape[1], s
        x, s, lut, probs, pmean = block(
            p, x, s, cfg, want_attn=want_attn, want_mean=want_attn)
        if want_attn:
            attns.append(probs.astype(x.dtype))
            rollout = attn_ops.rollout_step(pmean, rollout)
            if x.shape[1] != n_in:
                # merged carry rows combine with the PRE-merge sizes —
                # the same weights the token values merged with
                rollout, _ = tome_ops.apply_merge(
                    rollout, s_prev, lut, x.shape[1])
    out: Dict[str, Any] = {
        "logits": vit.head(params, vit.final_norm(params, x[:, :1], cfg))
    }
    if want_attn:
        out["attn"] = tuple(attns)
        out["rollout"] = rollout
    return out


# -- graph-node decomposition ---------------------------------------------------


def layer_fns(cfg: ToMeViTConfig):
    """Tappable layer list (vit.layer_fns contract) with the ToMe
    channels: blocks chain ``s`` (sizes) and ``a`` (assignment) alongside
    ``o``, and add the ``merge`` color-map tap."""
    layers: List[Tuple[str, List[str], Callable]] = []
    base = vit.layer_fns(cfg)
    layers.append(base[0])   # transform
    layers.append(base[1])   # embed

    def make_block_fn(i):
        def block_fn(p, ins, want=frozenset(), node_params=None):
            x = ins["o"]
            b, n = x.shape[0], x.shape[1]
            s = ins.get("s")
            if s is None:
                s = jnp.ones((b, n), jnp.float32)
            sel = vit.parse_attn_heads(node_params)
            if sel is not None and any(
                    h < 0 or h >= cfg.heads for h in sel):
                raise ValueError(f"attn_heads {sorted(sel)} out of range "
                                 f"for {cfg.heads} heads")
            s_prev = s
            y, s, lut, probs, pmean = block(
                p, x, s, cfg, want_attn="attn" in want,
                want_mean="r" in want)
            outs = {"o": y, "s": s}
            if probs is not None and "attn" in want:
                if sel is not None:
                    probs = probs[:, list(sorted(set(sel))), :, :]
                outs["attn"] = probs
            if "r" in want:
                rolled = vit.rollout_carry(pmean, ins, x)
                if y.shape[1] != n:
                    rolled, _ = tome_ops.apply_merge(
                        rolled, s_prev, lut, y.shape[1])
                outs["r"] = rolled.astype(y.dtype)
            if "a" in want or "merge" in want:
                a = ins.get("a")
                if a is None:
                    if n != cfg.tokens:
                        raise ValueError(
                            "merge/assignment taps need the 'a' channel "
                            "wired from the first block (the saved "
                            f"{cfg.name}.json wires it); got an unwired "
                            f"'a' at N={n} != N0={cfg.tokens}")
                    a = jnp.broadcast_to(
                        jnp.arange(n, dtype=jnp.int32), (b, n))
                a = jnp.take_along_axis(lut, a, axis=1)
                outs["a"] = a
                if "merge" in want:
                    outs["merge"] = tome_ops.merge_map_render(a).astype(
                        y.dtype)
            if "cls" in want:
                outs["cls"] = y[:, 0]
            return outs

        return block_fn

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["s", "a", "attn", "r", "cls",
                                       "merge"], make_block_fn(i)))
    layers.append(base[-2])  # norm
    layers.append(base[-1])  # head
    return layers


layer_params = vit.layer_params  # same pytree layout
