"""CLIP text encoder — completes the CLIP family begun in ``models/clip.py``.

The reference app is single-modal (torchvision VGG16 only,
``/root/reference/static/models/vgg16.py:10-14``); the rebuild's CLIP config
(BASELINE config 4) gets its second tower here so the embedding-extraction
path ends in something useful: zero-shot classification of any image node
against user-typed prompts (``ops/node_ops.ClipSimNode``).

Architecture (OpenAI CLIP text transformer, ViT-B/32 scale): token embedding
+ learned positions over a 77-token context, 12 pre-LN blocks of width 512 /
8 heads with QuickGELU MLPs and a CAUSAL attention mask, ``ln_final``, pool
the features at each sequence's end-of-text position, then a bias-free
projection into the shared 512-d embedding space, L2-normalized.

Notes: the causal attention is a plain jnp path (the attention kernels
take no causal mask)
with f32 softmax and ``mm_precision`` discipline; the whole tower stages
into the executor's single fused program with weights as device-resident
captures like every other model family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models.clip import quick_gelu
from interactive_vit_tpu.ops import layers as L
from interactive_vit_tpu.ops.attention import qkv_proj

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    name: str = "clip_text_b32"
    vocab_size: int = 49408
    context: int = 77
    width: int = 512
    depth: int = 12
    heads: int = 8
    embed_dim: int = 512
    ln_eps: float = 1e-5

    @property
    def mlp_dim(self) -> int:
        return self.width * 4


from interactive_vit_tpu.utils.jit_init import jitted_init


@jitted_init
def init_params(key: jax.Array, cfg: CLIPTextConfig,
                dtype=jnp.float32) -> Params:
    keys = iter(jax.random.split(key, 4 + 4 * cfg.depth))
    d, md = cfg.width, cfg.mlp_dim

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, jnp.float32)
                * (fan_in ** -0.5)).astype(dtype)

    params: Params = {
        "token_emb": (jax.random.normal(next(keys),
                                        (cfg.vocab_size, d), jnp.float32)
                      * 0.02).astype(dtype),
        "pos_emb": (jax.random.normal(next(keys), (cfg.context, d),
                                      jnp.float32) * 0.01).astype(dtype),
        "blocks": [],
        "ln_final": {"s": jnp.ones((d,), dtype), "b": jnp.zeros((d,), dtype)},
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


def causal_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                     want_attn: bool = False
                     ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """softmax(qk^T/sqrt(dh) + causal mask) v, inputs [B,H,N,Dh].

    Delegates to ``ops.attention.attention_reference(causal=True)`` so the
    precision discipline (HIGHEST f32 dots, f32 softmax) lives in one
    place. CLIP attends causally over the full padded context (zero-pad
    positions included); positions at or before each row never see the
    padding, so the pooled eot features are padding-independent by
    construction.
    """
    from interactive_vit_tpu.ops.attention import attention_reference

    return attention_reference(q, k, v, want_attn=want_attn, causal=True)


def block(p: Params, x: jnp.ndarray, cfg: CLIPTextConfig,
          want_attn: bool = False
          ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    b, n, d = x.shape
    h = L.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    q, k, v = qkv_proj(h, p, cfg.heads)
    attn_out, probs = causal_attention(q, k, v, want_attn=want_attn)
    attn_out = attn_out.transpose(0, 2, 1, 3).reshape(b, n, d)
    x = x + L.linear(attn_out, p["proj_w"], p["proj_b"])
    h = L.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
    x = x + L.linear(quick_gelu(L.linear(h, p["fc1_w"], p["fc1_b"])),
                     p["fc2_w"], p["fc2_b"])
    return x, probs


def embed(params: Params, tokens: jnp.ndarray, cfg: CLIPTextConfig
          ) -> jnp.ndarray:
    """Token ids [P, N] -> [P, N, D] embedded + positioned."""
    x = jnp.take(params["token_emb"], tokens, axis=0)
    return x + params["pos_emb"][None, : tokens.shape[1]].astype(x.dtype)


def pool_project(params: Params, x: jnp.ndarray, eot: jnp.ndarray,
                 cfg: CLIPTextConfig, normalize: bool = True) -> jnp.ndarray:
    """ln_final -> features at the eot position [P] -> projection -> L2 norm.

    ``eot`` carries each prompt's end-of-text index. OpenAI CLIP derives it
    as ``argmax(tokens)`` — valid because the eot id is the largest in the
    vocabulary (``clip_bpe`` constructs the vocab with the specials last)
    and padding is zeros; ``forward`` does the same, while the graph path
    ships it host-computed on the embed node's ``eot`` channel.
    """
    x = L.layer_norm(x, params["ln_final"]["s"], params["ln_final"]["b"],
                     cfg.ln_eps)
    pooled = jnp.take_along_axis(x, eot[:, None, None].astype(jnp.int32),
                                 axis=1)[:, 0]
    emb = jnp.dot(pooled, params["proj"], preferred_element_type=jnp.float32,
                  precision=L.mm_precision(pooled, params["proj"]))
    if normalize:
        emb = emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)
    return emb.astype(x.dtype)


def forward(params: Params, tokens: jnp.ndarray, cfg: CLIPTextConfig,
            want_attn: bool = False) -> Dict[str, jnp.ndarray]:
    x = embed(params, tokens, cfg)
    attns: List[jnp.ndarray] = []
    for p in params["blocks"]:
        x, probs = block(p, x, cfg, want_attn=want_attn)
        if want_attn:
            attns.append(probs.astype(x.dtype))
    out = {"embedding": pool_project(params, x,
                                     jnp.argmax(tokens, axis=-1), cfg)}
    if want_attn:
        out["attn"] = tuple(attns)
    return out


# -- node decomposition -----------------------------------------------------


def layer_fns(cfg: CLIPTextConfig):
    """Tappable chain: embed (prompts live here) -> blocks.i -> embedding.

    The embed node has no tensor input — its tokens (and each prompt's eot
    index) arrive as captures built from the node's ``prompts`` param
    (``clip_text_plugin``). The eot indices leave the embed node on an
    ``eot`` extra channel wired DIRECTLY to the pooling node in the
    generated graph, so the 12-block chain stays a plain activation chain
    with per-block causal attention-map taps, same shape as the vision
    towers.
    """
    layers: List[Tuple[str, List[str], Callable]] = []

    def embed_fn(p, ins, want=frozenset()):
        outs = {"o": embed(p["weights"], p["tokens"], cfg)}
        if "eot" in want:
            outs["eot"] = p["eot"]
        return outs

    layers.append(("embed", ["eot"], embed_fn))

    def block_fn(p, ins, want=frozenset()):
        y, probs = block(p, ins["o"], cfg, want_attn="attn" in want)
        outs = {"o": y}
        if probs is not None:
            outs["attn"] = probs
        return outs

    for i in range(cfg.depth):
        layers.append((f"blocks.{i}", ["attn"], block_fn))

    layers.append(("embedding", [], lambda p, ins: {
        "o": pool_project(p, ins["o"], ins["eot"], cfg)
    }))
    return layers


def layer_params(params: Params, layer_name: str):
    if layer_name.startswith("blocks."):
        return params["blocks"][int(layer_name.split(".", 1)[1])]
    if layer_name == "embed":
        # wrapped one level down: the plugin adds the tokens capture beside
        # the weights so the pytree structure stays {weights, tokens}
        return {"token_emb": params["token_emb"], "pos_emb": params["pos_emb"]}
    if layer_name == "embedding":
        return {"ln_final": params["ln_final"], "proj": params["proj"]}
    return {}


def from_openai(sd: Dict[str, Any], cfg: CLIPTextConfig,
                dtype=jnp.float32) -> Params:
    """OpenAI CLIP state dict (text-side keys, as numpy) -> our pytree.

    Accepts the full-model dict: text keys are unprefixed
    (``transformer.resblocks.*``, ``token_embedding.weight``, ...), which
    is how the published checkpoints name them next to ``visual.*``.
    """
    import numpy as np

    def get(name):
        return np.asarray(sd[name], dtype=np.float32)

    params: Params = {
        "token_emb": jnp.asarray(get("token_embedding.weight"), dtype),
        "pos_emb": jnp.asarray(get("positional_embedding"), dtype),
        "blocks": [],
        "ln_final": {
            "s": jnp.asarray(get("ln_final.weight"), dtype),
            "b": jnp.asarray(get("ln_final.bias"), dtype),
        },
        "proj": jnp.asarray(get("text_projection"), dtype),
    }
    for i in range(cfg.depth):
        pre = f"transformer.resblocks.{i}."
        params["blocks"].append(
            {
                "ln1_s": jnp.asarray(get(pre + "ln_1.weight"), dtype),
                "ln1_b": jnp.asarray(get(pre + "ln_1.bias"), dtype),
                "qkv_w": jnp.asarray(get(pre + "attn.in_proj_weight").T, dtype),
                "qkv_b": jnp.asarray(get(pre + "attn.in_proj_bias"), dtype),
                "proj_w": jnp.asarray(get(pre + "attn.out_proj.weight").T,
                                      dtype),
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
