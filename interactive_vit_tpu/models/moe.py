"""Mixture-of-Experts ViT — the EP (expert-parallel) model family.

The reference has no parallelism at all (SURVEY §2.3: "The reference has
NONE of these as code"); EP was the one axis of the rebuild's parallelism
matrix covered only as a documented non-goal ("no MoE in scope"). This
module closes it the static-shape way: a Switch-style routed MLP whose experts
shard over the mesh "model" axis, written entirely as static-shape
einsums so XLA/GSPMD lowers the token dispatch/combine to matmuls +
collectives — no gather/scatter, no dynamic shapes, no host routing.

Routing (Switch Transformer, top-1, capacity-factor dropping, grouped
PER IMAGE — see ``route`` for why per-image grouping is a performance
contract, not a detail):

- router logits ``x @ router_w`` -> softmax gates [B, N, E] (f32);
- each token goes to its argmax expert; tokens beyond an expert's
  per-image capacity ``C = ceil(f * N / E)`` are DROPPED (residual
  passthrough) — the standard Switch overflow semantics;
- dispatch is a one-hot [B, N, E, C] mask, so ``expert_in =
  einsum('bnec,bnd->becd')`` and the combine is its transpose weighted
  by the gate — dense matmuls, the canonical GShard/Switch formulation;
- experts run as ONE batched MLP over the E dim ([B,E,C,D] x [E,D,M])
  — one batched contraction, and the E dim is what EP shards.

EP = ``param_spec`` maps ``exp_*`` weights to ``P("model", ...)``: with
experts sharded over "model" the dispatch einsum's [E,C,D] output is
E-sharded, GSPMD inserts the token all-to-all, and each device
runs only its experts — the GSPMD idiom for expert parallelism (the
hand-written alternative, shard_map + lax.all_to_all, buys nothing here
because the routing masks are already dense einsum operands).

The per-token expert assignment is TAPPABLE: MoE blocks expose an
"experts" channel carrying the router's gate probabilities [B, N, E] —
splice a viewer on it to watch which patches each expert claims (the
product's interactive contract extended to routing).

Aux loss: the Switch load-balance term ``E * Σ_e f_e · P_e`` (fraction
routed x mean gate prob), returned by ``forward(..., want_aux=True)``
for the trainer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import vit
from interactive_vit_tpu.ops import attention as attn_ops
from interactive_vit_tpu.ops import layers as L

Params = Any


@dataclasses.dataclass(frozen=True)
class MoEViTConfig(vit.ViTConfig):
    """ViT whose odd blocks (``moe_every``-strided) use a routed MLP."""

    n_experts: int = 8
    moe_every: int = 2          # blocks.i is MoE iff i % moe_every == 1
    capacity_factor: float = 1.25

    def is_moe(self, i: int) -> bool:
        return i % self.moe_every == (self.moe_every - 1)

    def capacity(self, n_tokens: int) -> int:
        """Expert buffer slots PER IMAGE (``n_tokens`` = tokens per
        routing group, i.e. per batch element — see ``route``)."""
        return max(1, math.ceil(
            self.capacity_factor * n_tokens / self.n_experts))


VARIANTS: Dict[str, MoEViTConfig] = {
    # ViT-S/16 trunk, 8 experts in every other block: the demo family.
    # Active params per token match vit_s16 (top-1 routing); total params
    # carry 8x the routed-MLP weight — the MoE trade.
    "vit_moe_s16": MoEViTConfig("vit_moe_s16", 224, 16, 384, 12, 6,
                                n_experts=8),
}


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: MoEViTConfig,
                dtype=jnp.float32) -> Params:
    """vit.init_params with MoE blocks' MLP swapped for router + experts."""
    params = vit.init_params(key, cfg, dtype=dtype)
    d, md, e = cfg.width, cfg.mlp_dim, cfg.n_experts
    keys = iter(jax.random.split(jax.random.fold_in(key, 0x40E),
                                 3 * cfg.depth))

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(dtype)

    for i in range(cfg.depth):
        if not cfg.is_moe(i):
            continue
        b = params["blocks"][i]
        for name in ("fc1_w", "fc1_b", "fc2_w", "fc2_b"):
            del b[name]
        b["router_w"] = dense(next(keys), d, (d, e))
        b["exp_fc1_w"] = dense(next(keys), d, (e, d, md))
        b["exp_fc1_b"] = jnp.zeros((e, md), dtype)
        b["exp_fc2_w"] = dense(next(keys), md, (e, md, d))
        b["exp_fc2_b"] = jnp.zeros((e, d), dtype)
    return params


# -- the routed MLP ------------------------------------------------------------


def route(x: jnp.ndarray, router_w, cfg: MoEViTConfig):
    """Top-1 capacity routing, PER IMAGE. ``x`` [B, N, D] (already LN'ed).

    Returns ``(dispatch [B,N,E,C], combine [B,N,E,C], gates [B,N,E]
    f32)``: dispatch is the 0/1 token->slot assignment, combine =
    dispatch weighted by the token's gate prob.

    Routing groups = batch elements (the GShard/V-MoE convention), with
    capacity ``C = ceil(f * N / E)`` per image. This is a PERFORMANCE
    contract, not just semantics: a flattened [S=B*N] formulation makes
    the dispatch one-hot [S, E, C] with C ∝ S, so the dispatch/combine
    einsums cost O(S²·D·f): 4x the batch is 16x the dispatch work.
    Per-image grouping keeps every shape
    linear in batch, and the batch dim stays the DP shard axis.
    """
    n = x.shape[1]
    e, c = cfg.n_experts, cfg.capacity(n)
    logits = jnp.einsum("bnd,de->bne", x, router_w,
                        preferred_element_type=jnp.float32,
                        precision=L.mm_precision(x, router_w))
    gates = jax.nn.softmax(logits, axis=-1)          # [B, N, E] f32
    expert = jnp.argmax(gates, axis=-1)              # [B, N]
    onehot = jax.nn.one_hot(expert, e, dtype=jnp.float32)
    # position of each token within its expert's buffer (token order —
    # earlier tokens win capacity, the Switch convention)
    pos = jnp.cumsum(onehot, axis=1) * onehot        # [B, N, E], 1-based
    kept = onehot * (pos <= c)                       # overflow drops
    slot = jax.nn.one_hot(((pos - 1.0) * onehot).astype(jnp.int32), c,
                          dtype=jnp.float32)         # [B, N, E, C]
    dispatch = kept[..., None] * slot                # [B, N, E, C]
    top_gate = jnp.sum(gates * kept, axis=-1)        # [B, N] (0 dropped)
    combine = dispatch * top_gate[..., None, None]
    return dispatch, combine, gates


def moe_mlp(x: jnp.ndarray, p: Params, cfg: MoEViTConfig,
            ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Routed MLP branch on [B, N, D] (post-LN input, no residual).

    Returns ``(y [B,N,D], gates [B,N,E] f32, aux scalar f32)``. Dropped
    tokens contribute 0 (caller's residual passes them through).
    """
    dispatch, combine, gates = route(x, p["router_w"], cfg)
    dd = dispatch.astype(x.dtype)
    expert_in = jnp.einsum("bnec,bnd->becd", dd, x,
                           preferred_element_type=jnp.float32,
                           precision=L.mm_precision(dd, x)
                           ).astype(x.dtype)
    h = jnp.einsum("becd,edm->becm", expert_in, p["exp_fc1_w"],
                   preferred_element_type=jnp.float32,
                   precision=L.mm_precision(expert_in, p["exp_fc1_w"])
                   ) + p["exp_fc1_b"][None, :, None, :]
    h = L.gelu(h.astype(x.dtype))
    out = jnp.einsum("becm,emd->becd", h, p["exp_fc2_w"],
                     preferred_element_type=jnp.float32,
                     precision=L.mm_precision(h, p["exp_fc2_w"])
                     ) + p["exp_fc2_b"][None, :, None, :]
    y = jnp.einsum("bnec,becd->bnd", combine.astype(jnp.float32),
                   out.astype(jnp.float32),
                   precision=L.mm_precision(combine)).astype(x.dtype)
    # Switch load-balance loss: E * sum_e f_e * P_e, with f_e the RAW
    # routing fraction (pre-capacity-drop): computing it from the kept
    # dispatch mask would cap f_hot at C/S ~ capacity_factor/E exactly
    # when an expert is overloaded — plateauing the corrective gradient
    # in the collapsed regime the loss exists to prevent
    assign = jax.nn.one_hot(jnp.argmax(gates, axis=-1), cfg.n_experts,
                            dtype=jnp.float32)
    frac = jnp.mean(assign, axis=(0, 1))             # [E] routed fraction
    prob = jnp.mean(gates, axis=(0, 1))              # [E] mean gate prob
    aux = cfg.n_experts * jnp.sum(frac * prob)
    return y, gates, aux


def moe_mlp_reference(x: jnp.ndarray, p: Params,
                      cfg: MoEViTConfig) -> jnp.ndarray:
    """Semantic ground truth: per-token python loop (tests only).

    Capacity is PER IMAGE (routing groups = batch elements), matching
    ``route``'s contract."""
    import numpy as np

    bsz, n, d = x.shape
    xf = np.asarray(x, dtype=np.float32)
    rw = np.asarray(p["router_w"], dtype=np.float32)
    c = cfg.capacity(n)
    y = np.zeros_like(xf)
    for b_i in range(bsz):
        logits = xf[b_i] @ rw
        gates = np.exp(logits - logits.max(-1, keepdims=True))
        gates /= gates.sum(-1, keepdims=True)
        expert = gates.argmax(-1)
        counts = np.zeros(cfg.n_experts, dtype=int)
        for t in range(n):
            e_i = int(expert[t])
            if counts[e_i] >= c:
                continue  # dropped: residual passthrough
            counts[e_i] += 1
            h = xf[b_i, t] @ np.asarray(p["exp_fc1_w"][e_i], np.float32)
            h += np.asarray(p["exp_fc1_b"][e_i], np.float32)
            h = np.asarray(L.gelu(jnp.asarray(h, x.dtype)), np.float32)
            o = h @ np.asarray(p["exp_fc2_w"][e_i], np.float32)
            o += np.asarray(p["exp_fc2_b"][e_i], np.float32)
            y[b_i, t] = gates[t, e_i] * o
    return jnp.asarray(y, x.dtype)


# -- block / forward -----------------------------------------------------------


def block(p: Params, x: jnp.ndarray, cfg: MoEViTConfig, i: int,
          want_attn: bool = False, want_mean: bool = False,
          attn_impl=None, qkv_head_major: bool = False):
    """Pre-LN block; MoE blocks return router gates as a 4th output.

    Attention goes through `attn_ops.mhsa` (and ``attn_impl``); the MLP
    is dense or routed per block.
    """
    h, probs = attn_ops.mhsa(
        L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps),
        p, cfg.heads, want_attn=want_attn or want_mean,
        attn_impl=attn_impl, head_major=qkv_head_major,
    )
    x = x + h
    pmean = None
    if want_mean and probs is not None:
        pmean = probs.astype(jnp.float32).mean(axis=1).astype(x.dtype)
    if not want_attn:
        probs = None
    h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
    if cfg.is_moe(i):
        y, gates, aux = moe_mlp(h, p, cfg)
        return x + y, probs, pmean, (gates, aux)
    x = x + L.mlp(h, p)
    return x, probs, pmean, None


def forward(params: Params, images: jnp.ndarray, cfg: MoEViTConfig,
            want_attn: bool = False, want_aux: bool = False,
            attn_impl=None, block_wrapper=None,
            qkv_head_major: bool = False) -> Dict[str, Any]:
    """Monolithic forward (training / bench path).

    ``block_wrapper`` (e.g. ``jax.checkpoint``): wraps each block for
    rematerialization, same contract as ``vit.forward``; requires taps
    off (wrapped blocks return only the flowing activation + aux).
    """
    x = vit.embed(params, images, cfg)
    attns, aux_sum = [], 0.0
    if block_wrapper is not None:
        if want_attn:
            raise ValueError("block_wrapper requires taps off")

        for i in range(cfg.depth):
            def one(p, x, i=i):
                y, _, _, moe_out = block(
                    p, x, cfg, i, attn_impl=attn_impl,
                    qkv_head_major=qkv_head_major)
                return y, (moe_out[1] if moe_out is not None
                           else jnp.float32(0))

            x, aux = block_wrapper(one)(params["blocks"][i], x)
            aux_sum = aux_sum + aux
    else:
        for i in range(cfg.depth):
            x, probs, _, moe_out = block(
                params["blocks"][i], x, cfg, i, want_attn=want_attn,
                attn_impl=attn_impl, qkv_head_major=qkv_head_major)
            if want_attn:
                attns.append(probs)
            if moe_out is not None:
                aux_sum = aux_sum + moe_out[1]
    x = vit.final_norm(params, x, cfg)
    out: Dict[str, Any] = {"logits": vit.head(params, x)}
    if want_attn:
        out["attn"] = tuple(attns)
    if want_aux:
        n_moe = sum(cfg.is_moe(i) for i in range(cfg.depth))
        out["aux"] = aux_sum / max(1, n_moe)
    return out


# -- graph-node decomposition --------------------------------------------------


def layer_fns(cfg: MoEViTConfig, attn_impl=None):
    """Tappable layer list (vit.layer_fns contract); MoE blocks add the
    "experts" channel: router gate probabilities [B, N, E]."""
    layers: List[Tuple[str, List[str], Callable]] = []
    base = vit.layer_fns(cfg, attn_impl=attn_impl)
    # transform + embed come straight from the ViT family
    layers.append(base[0])
    layers.append(base[1])

    def make_block_fn(i):
        def block_fn(p, ins, want=frozenset(), node_params=None):
            x = ins["o"]
            sel = vit.parse_attn_heads(node_params)
            if sel is not None and any(
                    h < 0 or h >= cfg.heads for h in sel):
                raise ValueError(f"attn_heads {sorted(sel)} out of range "
                                 f"for {cfg.heads} heads")
            y, probs, pmean, moe_out = block(
                p, x, cfg, i, want_attn="attn" in want,
                want_mean="r" in want, attn_impl=attn_impl)
            outs = {"o": y}
            if probs is not None and "attn" in want:
                # XLA path: full probs existed transiently; only the
                # selected heads persist as the tap (same contract as
                # the vit family's attn_heads control)
                if sel is not None:
                    probs = probs[:, list(sorted(set(sel))), :, :]
                outs["attn"] = probs
            if "r" in want:
                outs["r"] = vit.rollout_carry(pmean, ins, x)
            if moe_out is not None and "experts" in want:
                # render-ready: per-EXPERT gate heatmaps over the patch
                # grid [B, E, gh, gw] (CLS dropped) — the stock
                # multi_view node shows a sqrt(E) grid of assignment
                # maps with zero client logic
                gates = moe_out[0][:, 1:, :]          # [B, N-1, E]
                b = gates.shape[0]
                gh = cfg.img_size // cfg.patch
                outs["experts"] = (
                    gates.transpose(0, 2, 1)
                    .reshape(b, cfg.n_experts, gh, gh)
                    .astype(jnp.bfloat16))
            return outs

        return block_fn

    for i in range(cfg.depth):
        extras = ["attn", "r"] + (["experts"] if cfg.is_moe(i) else [])
        layers.append((f"blocks.{i}", extras, make_block_fn(i)))
    layers.append(base[-2])  # norm
    layers.append(base[-1])  # head
    return layers


layer_params = vit.layer_params  # same pytree layout
