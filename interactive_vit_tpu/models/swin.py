"""Swin Transformer — hierarchical windowed attention, every edge tappable.

Fourth architecture class through the plugin API (after plain ViT, the
conv nets, and MoE): multi-scale feature maps with LOCAL window attention
and shifted windows — the family a reference user reaches for when global
N^2 attention is too coarse (dense prediction) or too expensive at high
resolution. The reference wrapped one torch model generically
(``/root/reference/main/context.py:38-47``); this module is the same
contract for the Swin family, decomposed into tappable per-block nodes.

Design notes:

* Activations flow **NHWC** ``[B, H, W, C]``: window partitioning is then
  a static reshape/transpose chain (zero data-dependent control flow) and
  C is the contiguous dimension for the LN/MLP fusions.
* Window partition/merge, the shifted-window roll, the relative-position
  bias gather and the cross-boundary attention mask are all **static**:
  masks and bias indices are computed with numpy at trace time and enter
  the program as constants — nothing in the hot path branches.
* Attention runs per window over ``B * num_windows`` batched [49, C]
  tiles: small dots that run as one big batched contraction;
  softmax statistics in f32 (``ops.layers`` policy, CLAUDE.md trap #4).
* Shift wraparound uses ``jnp.roll`` with static shifts (lowers to two
  slices + concat, no gather).

Layout matches torchvision's ``swin_t``/``swin_s``/``swin_b`` (v1)
checkpoints exactly — ``from_torch`` converts their state dicts; the
parity oracle in ``tests/test_swin.py`` pins the naming and semantics
(roll direction, mask value -100, scale-then-dot order, merge
concatenation order).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.ops import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str
    img_size: int = 224
    patch: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: int = 4
    num_classes: int = 1000
    in_chans: int = 3
    ln_eps: float = 1e-5  # torch nn.LayerNorm default (ViT family uses 1e-6)

    def stage_res(self, s: int) -> int:
        """Feature-map side length at stage ``s`` (56/28/14/7 @224)."""
        return self.img_size // self.patch // (2 ** s)

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_shift(self, s: int, b: int) -> int:
        """Shift for block ``b`` of stage ``s``: odd blocks shift by
        window//2, clamped to 0 when the window covers the whole map
        (stage 3 @224 is 7x7 = one window — shifting would be a no-op
        roll plus a mask that blocks nothing; torchvision clamps the
        same way)."""
        if b % 2 == 0 or self.window >= self.stage_res(s):
            return 0
        return self.window // 2


VARIANTS: Dict[str, SwinConfig] = {
    "swin_t": SwinConfig("swin_t", depths=(2, 2, 6, 2)),
    "swin_s": SwinConfig("swin_s", depths=(2, 2, 18, 2)),
    "swin_b": SwinConfig("swin_b", embed_dim=128, depths=(2, 2, 18, 2),
                         heads=(4, 8, 16, 32)),
}


# -- static (trace-time) tables ---------------------------------------------------


def relative_position_index(window: int) -> np.ndarray:
    """[T, T] int index into the (2w-1)^2 relative-position bias table.

    The standard Swin construction: for token pair (i, j) in a w x w
    window, the index encodes (dy + w - 1) * (2w - 1) + (dx + w - 1)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))  # [2, w, w]
    flat = coords.reshape(2, -1)  # [2, T]
    rel = flat[:, :, None] - flat[:, None, :]  # [2, T, T]
    rel = rel.transpose(1, 2, 0).astype(np.int64)  # [T, T, 2]
    rel[..., 0] += window - 1
    rel[..., 1] += window - 1
    rel[..., 0] *= 2 * window - 1
    return rel.sum(-1)  # [T, T]


def shift_attn_mask(res: int, window: int, shift: int) -> Optional[np.ndarray]:
    """Additive attention mask [nW, T, T] for shifted windows, or None.

    After rolling by -shift, windows on the bottom/right edges contain
    tokens from disconnected image regions; pairs from different regions
    get -100 (the torch implementations' value — softmax underflows it
    to 0 in f32 AND bf16) so attention never crosses the wrap seam."""
    if shift == 0:
        return None
    img = np.zeros((res, res), np.int32)
    cnt = 0
    bounds = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in bounds:
        for ws in bounds:
            img[hs, ws] = cnt
            cnt += 1
    n = res // window
    wins = img.reshape(n, window, n, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(n * n, window * window)  # [nW, T]
    mask = (wins[:, None, :] != wins[:, :, None]).astype(np.float32) * -100.0
    return mask  # [nW, T, T]


# -- windowing ----------------------------------------------------------------


def window_partition(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """[B, H, W, C] -> [B, nW, T, C] with T = window^2 (static reshapes)."""
    b, h, w, c = x.shape
    nh, nw = h // window, w // window
    x = x.reshape(b, nh, window, nw, window, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)  # [B, nh, nw, win, win, C]
    return x.reshape(b, nh * nw, window * window, c)


def window_merge(x: jnp.ndarray, window: int, res: int) -> jnp.ndarray:
    """Inverse of ``window_partition``: [B, nW, T, C] -> [B, H, W, C]."""
    b, _nw, _t, c = x.shape
    n = res // window
    x = x.reshape(b, n, n, window, window, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, res, res, c)


# -- attention ----------------------------------------------------------------


def gather_bias(p: Params, bias_idx: np.ndarray, t: int,
                heads: int) -> jnp.ndarray:
    """[heads, T, T] relative-position bias from the (2w-1)^2 table.

    A trace-time constant expression per block (the gather index is
    numpy)."""
    bias = p["bias_table"][bias_idx.reshape(-1)]  # [T*T, heads]
    return bias.reshape(t, t, heads).transpose(2, 0, 1)


def window_attention(
    p: Params,
    xw: jnp.ndarray,
    heads: int,
    bias_idx: np.ndarray,
    mask: Optional[np.ndarray],
    want_attn: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """W-MSA over [B, nW, T, C] windows; returns (out, probs|None).

    probs is [B, nW, heads, T, T] (f32 softmax, emitted in the activation
    dtype). All dots accumulate f32 (``L.linear``); the relative-position
    bias gathers once at trace time into a [heads, T, T] constant-shaped
    operand added before the softmax, torch order: (q*scale) @ k^T +
    bias (+ mask) -> softmax -> @ v -> proj."""
    b, nw, t, c = xw.shape
    dh = c // heads
    qkv = L.linear(xw, p["qkv_w"], p["qkv_b"])  # [B, nW, T, 3C]
    qkv = qkv.reshape(b, nw, t, 3, heads, dh)
    # transpose-FREE head split: q/k/v stay [B, nW, T, heads, dh] and the
    # einsums contract them in place — the first on-chip trace showed 24%
    # of swin_t device time in "data formatting" (layout copies), and the
    # explicit [.., heads, T, dh] transposes were the biggest feeders;
    # dot_general folds these orderings into the contraction instead
    q, k, v = (qkv[..., i, :, :] for i in range(3))
    q = q * jnp.asarray(dh ** -0.5, q.dtype)
    scores = jnp.einsum(
        "bwthd,bwshd->bwhts", q, k,
        preferred_element_type=jnp.float32,
        precision=L.mm_precision(q, k),
    )
    bias = gather_bias(p, bias_idx, t, heads)  # [heads, T, T]
    scores = scores + bias.astype(jnp.float32)
    if mask is not None:
        scores = scores + jnp.asarray(mask, jnp.float32)[None, :, None]
    probs = jax.nn.softmax(scores, axis=-1).astype(xw.dtype)
    out = jnp.einsum(
        "bwhts,bwshd->bwthd", probs, v,
        preferred_element_type=jnp.float32,
        precision=L.mm_precision(probs, v),
    ).astype(xw.dtype)
    # [B, nW, T, heads, dh] -> [B, nW, T, C] is a pure reshape: no copy
    out = out.reshape(b, nw, t, c)
    out = L.linear(out, p["proj_w"], p["proj_b"])
    return out, (probs if want_attn else None)


def block(
    p: Params,
    x: jnp.ndarray,
    cfg: SwinConfig,
    stage: int,
    shift: int,
    want_attn: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """One Swin block over [B, H, W, C]: x + W-MSA(LN(x)) then
    x + MLP(LN(x)), windows (shifted by ``shift``) inside the attention.

    Returns (y, probs [B, nW, heads, T, T] | None); probs are in the
    PRE-ROLL window order when shifted (the tap shows what the softmax
    actually computed — window w of a shifted block covers the rolled
    tile, seam pairs masked to 0)."""
    res = cfg.stage_res(stage)
    if x.shape[1] != res or x.shape[2] != res:
        raise ValueError(
            f"stage {stage} expects {res}x{res} maps, got "
            f"{x.shape[1]}x{x.shape[2]}")
    if res % cfg.window:
        raise ValueError(
            f"feature map {res} not divisible by window {cfg.window}")
    y = L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    if shift:
        y = jnp.roll(y, (-shift, -shift), axis=(1, 2))
    mask = shift_attn_mask(res, cfg.window, shift)
    yw = window_partition(y, cfg.window)
    aw, probs = window_attention(
        p, yw, cfg.heads[stage], relative_position_index(cfg.window),
        mask, want_attn=want_attn)
    a = window_merge(aw, cfg.window, res)
    if shift:
        a = jnp.roll(a, (shift, shift), axis=(1, 2))
    x = x + a
    x = x + L.mlp(L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps), p)
    return x, probs


def patch_merging(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    """Downsample 2x: concat each 2x2 neighborhood -> LN(4C) ->
    Linear(4C, 2C, no bias). Concat order (torch): (0,0), (1,0), (0,1),
    (1,1) — row offset fastest."""
    x0 = x[:, 0::2, 0::2]
    x1 = x[:, 1::2, 0::2]
    x2 = x[:, 0::2, 1::2]
    x3 = x[:, 1::2, 1::2]
    y = jnp.concatenate([x0, x1, x2, x3], axis=-1)
    y = L.layer_norm(y, p["ln_s"], p["ln_b"], 1e-5)
    return L.linear(y, p["w"], None)


def patch_embed(p: Params, images: jnp.ndarray, cfg: SwinConfig) -> jnp.ndarray:
    """[B, C, H, W] -> [B, H/p, W/p, D]: patchify matmul + LayerNorm.

    The stride-4 conv expressed as ONE [B*N, C*p*p] @ [C*p*p, D]
    matmul (same patchify layout as the ViT family); activations adopt
    the weight dtype here — the model's single entry point."""
    act_dtype = p["w"].dtype if hasattr(p["w"], "dtype") else p["b"].dtype
    images = images.astype(act_dtype)
    if images.ndim == 3:
        images = images[None]
    x = L.patch_embed(images, p, cfg.patch)  # [B, N, D]
    g = cfg.img_size // cfg.patch
    x = x.reshape(x.shape[0], g, g, cfg.embed_dim)
    return L.layer_norm(x, p["ln_s"], p["ln_b"], cfg.ln_eps)


def final_norm(p: Params, x: jnp.ndarray, cfg: SwinConfig) -> jnp.ndarray:
    return L.layer_norm(x, p["s"], p["b"], cfg.ln_eps)


def global_pool(x: jnp.ndarray) -> jnp.ndarray:
    """[B, H, W, C] -> [B, C] mean pool (f32 accumulation)."""
    return jnp.mean(x.astype(jnp.float32), axis=(1, 2)).astype(x.dtype)


def head(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    return L.linear(x, p["w"], p["b"])


# -- init / conversion -------------------------------------------------------


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: SwinConfig, dtype=jnp.float32) -> Params:
    """Random init mirroring the forward layout (trunc-normal-ish)."""
    n_blocks = sum(cfg.depths)
    keys = iter(jax.random.split(key, 4 + 6 * n_blocks + len(cfg.depths)))
    pdim = cfg.in_chans * cfg.patch * cfg.patch

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(dtype)

    def ln(c):
        return jnp.ones((c,), dtype), jnp.zeros((c,), dtype)

    d0 = cfg.embed_dim
    pe_s, pe_b = ln(d0)
    params: Params = {
        "patch_embed": {
            "w": dense(next(keys), pdim, (pdim, d0)),
            "b": jnp.zeros((d0,), dtype),
            "ln_s": pe_s, "ln_b": pe_b,
        },
        "stages": [],
        "merges": [],
        "norm": {},
        "head": {},
    }
    tbl = (2 * cfg.window - 1) ** 2
    for s, depth in enumerate(cfg.depths):
        c = cfg.stage_dim(s)
        md = c * cfg.mlp_ratio
        blocks = []
        for _ in range(depth):
            l1s, l1b = ln(c)
            l2s, l2b = ln(c)
            blocks.append({
                "ln1_s": l1s, "ln1_b": l1b,
                "qkv_w": dense(next(keys), c, (c, 3 * c)),
                "qkv_b": jnp.zeros((3 * c,), dtype),
                "bias_table": (jax.random.normal(
                    next(keys), (tbl, cfg.heads[s]), jnp.float32)
                    * 0.02).astype(dtype),
                "proj_w": dense(next(keys), c, (c, c)),
                "proj_b": jnp.zeros((c,), dtype),
                "ln2_s": l2s, "ln2_b": l2b,
                "fc1_w": dense(next(keys), c, (c, md)),
                "fc1_b": jnp.zeros((md,), dtype),
                "fc2_w": dense(next(keys), md, (md, c)),
                "fc2_b": jnp.zeros((c,), dtype),
            })
        params["stages"].append(blocks)
        if s + 1 < len(cfg.depths):
            ms, mb = ln(4 * c)
            params["merges"].append({
                "ln_s": ms, "ln_b": mb,
                "w": dense(next(keys), 4 * c, (4 * c, 2 * c)),
            })
    cf = cfg.stage_dim(len(cfg.depths) - 1)
    ns, nb = ln(cf)
    params["norm"] = {"s": ns, "b": nb}
    if cfg.num_classes:
        params["head"] = {
            "w": dense(next(keys), cf, (cf, cfg.num_classes)),
            "b": jnp.zeros((cfg.num_classes,), dtype),
        }
    return params


def from_torch(sd: Dict[str, Any], cfg: SwinConfig, dtype=jnp.float32) -> Params:
    """torchvision ``swin_t``-style (v1) state dict -> our pytree.

    features.0 = patch embed (conv 4x4 + LN), features.{1,3,5,7} = stages,
    features.{2,4,6} = patch mergings. Linear weights transpose to our
    [D_in, D_out]; the patch conv [D, C, p, p] reshapes to the patchify
    layout exactly like the ViT converter (``weights.from_torchvision``)."""
    def get(name):
        if name not in sd:
            raise KeyError(f"state dict missing {name!r}")
        return np.asarray(sd[name], np.float32)

    d0 = cfg.embed_dim
    params: Params = {
        "patch_embed": {
            "w": jnp.asarray(get("features.0.0.weight").reshape(d0, -1).T,
                             dtype),
            "b": jnp.asarray(get("features.0.0.bias"), dtype),
            "ln_s": jnp.asarray(get("features.0.2.weight"), dtype),
            "ln_b": jnp.asarray(get("features.0.2.bias"), dtype),
        },
        "stages": [],
        "merges": [],
        "norm": {
            "s": jnp.asarray(get("norm.weight"), dtype),
            "b": jnp.asarray(get("norm.bias"), dtype),
        },
        "head": (
            {
                "w": jnp.asarray(get("head.weight").T, dtype),
                "b": jnp.asarray(get("head.bias"), dtype),
            }
            if cfg.num_classes else {}
        ),
    }
    for s, depth in enumerate(cfg.depths):
        fi = 2 * s + 1
        blocks = []
        for b in range(depth):
            pre = f"features.{fi}.{b}."
            blocks.append({
                "ln1_s": jnp.asarray(get(pre + "norm1.weight"), dtype),
                "ln1_b": jnp.asarray(get(pre + "norm1.bias"), dtype),
                "qkv_w": jnp.asarray(get(pre + "attn.qkv.weight").T, dtype),
                "qkv_b": jnp.asarray(get(pre + "attn.qkv.bias"), dtype),
                "bias_table": jnp.asarray(
                    get(pre + "attn.relative_position_bias_table"), dtype),
                "proj_w": jnp.asarray(get(pre + "attn.proj.weight").T, dtype),
                "proj_b": jnp.asarray(get(pre + "attn.proj.bias"), dtype),
                "ln2_s": jnp.asarray(get(pre + "norm2.weight"), dtype),
                "ln2_b": jnp.asarray(get(pre + "norm2.bias"), dtype),
                "fc1_w": jnp.asarray(get(pre + "mlp.0.weight").T, dtype),
                "fc1_b": jnp.asarray(get(pre + "mlp.0.bias"), dtype),
                "fc2_w": jnp.asarray(get(pre + "mlp.3.weight").T, dtype),
                "fc2_b": jnp.asarray(get(pre + "mlp.3.bias"), dtype),
            })
        params["stages"].append(blocks)
        if s + 1 < len(cfg.depths):
            mpre = f"features.{fi + 1}."
            params["merges"].append({
                "ln_s": jnp.asarray(get(mpre + "norm.weight"), dtype),
                "ln_b": jnp.asarray(get(mpre + "norm.bias"), dtype),
                "w": jnp.asarray(get(mpre + "reduction.weight").T, dtype),
            })
    return params


# -- monolithic forward (bench/training path) ---------------------------------


def forward(
    params: Params,
    images: jnp.ndarray,
    cfg: SwinConfig,
    want_attn: bool = False,
    block_wrapper=None,
) -> Dict[str, jnp.ndarray]:
    """Full forward: [B,3,H,W] -> {"logits": [B,K]} (+ "attn": per-block
    tuple of [B, nW, heads, T, T] window-attention maps when requested —
    a tuple, not stacked: shapes differ per stage).

    ``block_wrapper``: training hook — each block becomes one
    ``(p, x) -> y`` unit passed through the wrapper (``jax.checkpoint``
    for remat; same contract as ``vit.forward``, so the remat path
    cannot drift from the inference trunk). Taps don't compose with a
    single-output wrapper."""
    if block_wrapper is not None and want_attn:
        raise ValueError("block_wrapper requires taps off")
    x = patch_embed(params["patch_embed"], images, cfg)
    attns: List[jnp.ndarray] = []
    for s, blocks in enumerate(params["stages"]):
        for bi, p in enumerate(blocks):
            if block_wrapper is not None:
                shift = cfg.stage_shift(s, bi)

                def one(p, x, _s=s, _shift=shift):
                    return block(p, x, cfg, _s, _shift)[0]

                x = block_wrapper(one)(p, x)
                continue
            x, probs = block(p, x, cfg, s, cfg.stage_shift(s, bi),
                             want_attn=want_attn)
            if want_attn:
                attns.append(probs)
        if s < len(params["merges"]):
            x = patch_merging(params["merges"][s], x)
    x = final_norm(params["norm"], x, cfg)
    feats = global_pool(x)
    out = {"logits": (head(params["head"], feats)
                      if cfg.num_classes else feats)}
    if want_attn:
        out["attn"] = tuple(attns)
    return out


# -- graph-node decomposition --------------------------------------------------


def layer_fns(cfg: SwinConfig):
    """The model as ordered named tappable layers (see ``vit.layer_fns``).

    Surface: transform, patch_embed, stages.{s}.{b} (extra channel
    "attn" = [B, nW, heads, T, T] window maps), merge.{s} between stages,
    norm, pool, head — 20 nodes for swin_t."""
    layers: List[Tuple[str, List[str], Callable]] = []

    def transform_fn(p, ins):
        from interactive_vit_tpu.ops.preprocess_mm import preprocess_mm

        # torchvision's swin eval recipe: bicubic shorter-side resize to
        # 232 (not the 256/224 ImageNet default), center-crop 224
        return {"o": preprocess_mm(
            ins["o"], cfg.img_size,
            resize_to=int(cfg.img_size * 232 / 224), method="bicubic")}

    def embed_fn(p, ins):
        return {"o": patch_embed(p, ins["o"], cfg)}

    layers.append(("transform", [], transform_fn))
    layers.append(("patch_embed", [], embed_fn))

    def make_block_fn(s, b):
        shift = cfg.stage_shift(s, b)
        heads = cfg.heads[s]
        nw = (cfg.stage_res(s) // cfg.window) ** 2

        def block_fn(p, ins, want=frozenset(), node_params=None):
            y, probs = block(p, ins["o"], cfg, s, shift,
                             want_attn="attn" in want)
            outs = {"o": y}
            if "attn" in want:
                # selective taps, STATIC params (shape-changing -> in the
                # compile signature): attn_heads = JSON head list (shared
                # control with every transformer family), attn_win = one
                # window index, collapsing the tap to the [B,|sel|,T,T]
                # rank the vit client render path already understands
                from interactive_vit_tpu.models.vit import parse_attn_heads

                sel = parse_attn_heads(node_params)
                if sel is not None:
                    if any(h < 0 or h >= heads for h in sel):
                        raise ValueError(
                            f"attn_heads {sorted(sel)} out of range for "
                            f"{heads} heads")
                    probs = probs[:, :, list(sel)]
                win = (node_params or {}).get("attn_win", "")
                if win != "":
                    w = int(float(win))
                    if not 0 <= w < nw:
                        raise ValueError(
                            f"attn_win {w} out of range for {nw} windows")
                    probs = probs[:, w]
                outs["attn"] = probs
            return outs

        return block_fn

    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            layers.append((f"stages.{s}.{b}", ["attn"], make_block_fn(s, b)))
        if s + 1 < len(cfg.depths):
            def make_merge_fn():
                def merge_fn(p, ins):
                    return {"o": patch_merging(p, ins["o"])}

                return merge_fn

            layers.append((f"merge.{s}", [], make_merge_fn()))

    def norm_fn(p, ins):
        return {"o": final_norm(p, ins["o"], cfg)}

    def pool_fn(p, ins):
        return {"o": global_pool(ins["o"])}

    layers.append(("norm", [], norm_fn))
    layers.append(("pool", [], pool_fn))
    if cfg.num_classes:
        def head_fn(p, ins):
            return {"o": head(p, ins["o"])}

        layers.append(("head", [], head_fn))
    return layers


def layer_params(params: Params, layer_name: str) -> Any:
    if layer_name.startswith("stages."):
        _, s, b = layer_name.split(".")
        return params["stages"][int(s)][int(b)]
    if layer_name.startswith("merge."):
        return params["merges"][int(layer_name.split(".", 1)[1])]
    if layer_name == "patch_embed":
        return params["patch_embed"]
    if layer_name == "norm":
        return params["norm"]
    if layer_name == "head":
        return params["head"]
    return {}  # transform / pool have no params
