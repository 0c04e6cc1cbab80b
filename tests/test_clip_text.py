"""CLIP text tower: BPE tokenizer, torch parity, zero-shot node path.

The reference app has no text modality (its only model is torchvision VGG16,
``/root/reference/static/models/vgg16.py:10-14``); these tests pin the
rebuild's CLIP completion: tokenizer algorithm, causal tower numerics vs an
independent torch oracle, the prompts->embed->blocks->pool graph chain, and
the ``similarity`` zero-shot join.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.models import clip_text
from interactive_vit_tpu.models.clip_bpe import (
    SOT, EOT, ClipTokenizer, default_tokenizer,
)
from interactive_vit_tpu.models.clip_text_plugin import (
    DEFAULT_PROMPTS,
    generate_zeroshot_graph_json,
    make_clip_text_model,
)
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.wire.schema import graph_from_json

TOK = default_tokenizer()
CFG = clip_text.CLIPTextConfig(name="clip_text_test",
                               vocab_size=TOK.vocab_size, context=77,
                               width=64, depth=2, heads=4, embed_dim=32)


# -- tokenizer ---------------------------------------------------------------


def test_bpe_byte_fallback_roundtrip():
    s = "Hello, WORLD! café 123"
    ids = TOK.encode(s)
    # lower-cased, word-end markers become separators on decode
    assert TOK.decode(ids) == "hello , world ! café 1 2 3"


def test_bpe_specials_and_batch_layout():
    b = TOK.batch(["a cat"], context_length=77)
    assert b.shape == (1, 77) and b.dtype == np.int32
    assert b[0, 0] == TOK.sot_id
    eot_pos = int(np.argmax(b[0]))
    assert b[0, eot_pos] == TOK.eot_id
    assert (b[0, eot_pos + 1:] == 0).all()  # zero padding after eot
    # eot id is the vocabulary maximum — the argmax pooling invariant
    assert TOK.eot_id == TOK.vocab_size - 1


def test_bpe_truncation_keeps_eot():
    b = TOK.batch(["x" * 500], context_length=77)
    assert b[0, 76] == TOK.eot_id  # eot survives truncation in final slot


def test_bpe_ranked_merges_apply_in_order():
    t = ClipTokenizer(merges=[("h", "e"), ("he", "l"), ("l", "o</w>")])
    toks = [t.decoder[i] for i in t.encode("hello")]
    # rank order: h+e -> he, he+l -> hel; l+o</w> merges the tail
    assert toks == ["hel", "lo</w>"]
    # unmerged text falls back to bytes with a tagged final byte
    assert [t.decoder[i] for i in t.encode("hi")] == ["h", "i</w>"]


def test_bpe_merge_table_changes_ids_not_text():
    t = ClipTokenizer(merges=[("c", "a"), ("ca", "t</w>")])
    assert t.decode(t.encode("cat dog")) == "cat dog"
    assert len(t.encode("cat")) == 1  # fully merged


def test_load_merges(tmp_path):
    p = tmp_path / "merges.txt"
    p.write_text("#version: test\nh e\nhe l\n")
    from interactive_vit_tpu.models.clip_bpe import load_merges

    assert load_merges(str(p)) == [("h", "e"), ("he", "l")]


def test_byte_table_matches_published_construction():
    """Pin the GPT-2/CLIP byte table exactly (0xA1-0xAC both kept: the
    published construction is ``range(ord('¡'), ord('¬')+1)``)."""
    from interactive_vit_tpu.models.clip_bpe import bytes_to_unicode

    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), 0x100)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(0x100 + n)
            n += 1
    expected = dict(zip(bs, (chr(c) for c in cs)))
    assert bytes_to_unicode() == expected
    assert n == 68  # exactly 68 displaced bytes
    assert bytes_to_unicode()[0xAC] == "¬"


def test_full_merges_file_yields_published_vocab_size(tmp_path):
    """A full-size merges file (header + >=48894 rules + junk) must slice
    to exactly 48894 merges so vocab_size == 49408 and eot_id == 49407 —
    in range for a real checkpoint's 49408-row token embedding."""
    from interactive_vit_tpu.models.clip_bpe import load_merges

    syms = [f"a{i}" for i in range(49000)]
    lines = ["#version: 0.2"] + [f"{s} b" for s in syms] + ["trailing junk"]
    p = tmp_path / "big_merges.txt"
    p.write_text("\n".join(lines) + "\n")
    merges = load_merges(str(p))
    assert len(merges) == 49152 - 256 - 2  # 48894
    t = ClipTokenizer(merges=merges)
    assert t.vocab_size == 49408
    assert t.eot_id == 49407 and t.sot_id == 49406


# -- torch oracle ------------------------------------------------------------


class TorchCLIPText(nn.Module):
    """Minimal OpenAI-CLIP text tower with OpenAI state-dict naming."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.width
        from tests.test_clip import TorchCLIPVision

        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context, d))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [TorchCLIPVision.Block(d, cfg.heads) for _ in range(cfg.depth)]
        )
        self.ln_final = nn.LayerNorm(d, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(d, cfg.embed_dim))
        mask = torch.full((cfg.context, cfg.context), float("-inf"))
        self.register_buffer("attn_mask", mask.triu_(1), persistent=False)

    @torch.no_grad()
    def forward(self, tokens, normalize=True):
        x = self.token_embedding(tokens) + self.positional_embedding
        for blk in self.transformer.resblocks:
            h = blk.ln_1(x)
            y, _ = blk.attn(h, h, h, need_weights=False,
                            attn_mask=self.attn_mask)
            x = x + y
            x = x + blk.mlp.c_proj(blk.gelu(blk.mlp.c_fc(blk.ln_2(x))))
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0]), tokens.argmax(dim=-1)]
        emb = pooled @ self.text_projection
        if normalize:
            emb = emb / emb.norm(dim=-1, keepdim=True)
        return emb


def _openai_sd(params, cfg):
    """Our pytree -> OpenAI-named torch state dict (tensors shared)."""
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    sd = {
        "token_embedding.weight": t(params["token_emb"]),
        "positional_embedding": t(params["pos_emb"]),
        "ln_final.weight": t(params["ln_final"]["s"]),
        "ln_final.bias": t(params["ln_final"]["b"]),
        "text_projection": t(params["proj"]),
    }
    for i, blk in enumerate(params["blocks"]):
        pre = f"transformer.resblocks.{i}."
        sd[pre + "ln_1.weight"] = t(blk["ln1_s"])
        sd[pre + "ln_1.bias"] = t(blk["ln1_b"])
        sd[pre + "attn.in_proj_weight"] = t(blk["qkv_w"]).T.contiguous()
        sd[pre + "attn.in_proj_bias"] = t(blk["qkv_b"])
        sd[pre + "attn.out_proj.weight"] = t(blk["proj_w"]).T.contiguous()
        sd[pre + "attn.out_proj.bias"] = t(blk["proj_b"])
        sd[pre + "ln_2.weight"] = t(blk["ln2_s"])
        sd[pre + "ln_2.bias"] = t(blk["ln2_b"])
        sd[pre + "mlp.c_fc.weight"] = t(blk["fc1_w"]).T.contiguous()
        sd[pre + "mlp.c_fc.bias"] = t(blk["fc1_b"])
        sd[pre + "mlp.c_proj.weight"] = t(blk["fc2_w"]).T.contiguous()
        sd[pre + "mlp.c_proj.bias"] = t(blk["fc2_b"])
    return sd


@pytest.fixture(scope="module")
def both():
    params = clip_text.init_params(jax.random.key(0), CFG)
    tm = TorchCLIPText(CFG)
    tm.load_state_dict(_openai_sd(params, CFG))
    tm.eval()
    return params, tm


@pytest.fixture(scope="module")
def tokens():
    return TOK.batch(["a photo of a cat", "a diagram", "one two three"],
                     CFG.context)


def test_embedding_parity_vs_torch(both, tokens):
    params, tm = both
    ours = clip_text.forward(params, jnp.asarray(tokens), CFG)["embedding"]
    theirs = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(np.asarray(ours), theirs.numpy(), atol=1e-4)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(ours), axis=-1), np.ones(3), atol=1e-5)


def test_causal_mask_is_strict(both, tokens):
    params, _ = both
    out = clip_text.forward(params, jnp.asarray(tokens), CFG, want_attn=True)
    probs = np.asarray(out["attn"][0])
    iu = np.triu_indices(CFG.context, k=1)
    assert probs[:, :, iu[0], iu[1]].max() == 0.0


def test_padding_and_batch_independence(both):
    """A prompt's embedding must not depend on its batch neighbors: causal
    attention + eot pooling make the zero-padding invisible."""
    params, _ = both
    alone = clip_text.forward(
        params, jnp.asarray(TOK.batch(["a photo of a cat"], CFG.context)),
        CFG)["embedding"]
    batched = clip_text.forward(
        params, jnp.asarray(TOK.batch(
            ["a photo of a cat", "an extremely long unrelated prompt " * 6],
            CFG.context)), CFG)["embedding"]
    np.testing.assert_allclose(np.asarray(alone)[0], np.asarray(batched)[0],
                               atol=1e-6)


def test_from_openai_converter(both, tokens):
    params, _ = both
    sd = {k: v.numpy() for k, v in _openai_sd(params, CFG).items()}
    restored = clip_text.from_openai(sd, CFG)
    a = clip_text.forward(params, jnp.asarray(tokens), CFG)["embedding"]
    b = clip_text.forward(restored, jnp.asarray(tokens), CFG)["embedding"]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


# -- graph path --------------------------------------------------------------


@pytest.fixture(scope="module")
def reg_and_model():
    reg = Registry()
    register_builtin(reg)
    model = make_clip_text_model(cfg=CFG)
    model.register(reg)
    return reg, model


def test_text_chain_matches_forward(reg_and_model):
    reg, model = reg_and_model
    gobj = model.generate_graph_json()
    g = graph_from_json(gobj)
    out = Executor(reg).run(g)
    last = len(gobj["nodes"]) - 1
    emb = np.asarray(out[last]["o"])
    toks = TOK.batch(DEFAULT_PROMPTS, CFG.context)
    ref = clip_text.forward(model.params, jnp.asarray(toks), CFG)["embedding"]
    np.testing.assert_allclose(emb, np.asarray(ref), atol=1e-6)


def test_text_chain_attn_tap(reg_and_model):
    reg, model = reg_and_model
    gobj = model.generate_graph_json()
    g = graph_from_json(gobj)
    last = len(gobj["nodes"]) - 1
    out = Executor(reg).run(g, taps={(1, "attn"), (last, "o")})
    att = np.asarray(out[1]["attn"])
    assert att.shape == (len(DEFAULT_PROMPTS), CFG.heads,
                         CFG.context, CFG.context)
    np.testing.assert_allclose(att.sum(-1), np.ones_like(att.sum(-1)),
                               atol=1e-5)


def test_prompts_param_drives_output_shape(reg_and_model):
    reg, model = reg_and_model
    gobj = model.generate_graph_json()
    gobj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps(
        ["just one prompt"])
    g = graph_from_json(gobj)
    out = Executor(reg).run(g)
    assert np.asarray(out[len(gobj["nodes"]) - 1]["o"]).shape == (
        1, CFG.embed_dim)


def test_bad_prompts_param_is_structured_error(reg_and_model):
    from interactive_vit_tpu.graph.executor import NodeError

    reg, model = reg_and_model
    gobj = model.generate_graph_json()
    gobj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps([1, 2])
    # per-node attribution contract: the failure names the embed node
    with pytest.raises(NodeError, match="embed.*prompts") as ei:
        Executor(reg).run(graph_from_json(gobj))
    assert ei.value.node_index == 0


def test_similarity_node_math(reg_and_model):
    reg, _ = reg_and_model
    from interactive_vit_tpu.graph.ir import Graph

    g = Graph()
    n = g.add_node("similarity", {"scale": "10"})
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 8)).astype(np.float32)
    b = rng.standard_normal((3, 8)).astype(np.float32)
    g.add_input(a, n, "a")
    g.add_input(b, n, "b")
    out = np.asarray(Executor(reg).run(g)[0]["o"])
    an = a / np.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / np.linalg.norm(b, axis=-1, keepdims=True)
    np.testing.assert_allclose(out, 10.0 * an @ bn.T, atol=1e-5)
    assert out.shape == (2, 3)


def test_zeroshot_graph_evaluates(reg_and_model, monkeypatch):
    reg, model = reg_and_model
    from interactive_vit_tpu.models import clip as clip_vision
    from interactive_vit_tpu.models.clip_plugin import make_clip_model
    import interactive_vit_tpu.models.clip_text_plugin as ctp

    vcfg = clip_vision.CLIPVisionConfig(
        name="clip_b32", img_size=32, patch=16, width=64, depth=2,
        heads=4, embed_dim=32)
    make_clip_model(cfg=vcfg).register(reg)
    tcfg = clip_text.CLIPTextConfig(
        name=CFG.name, vocab_size=CFG.vocab_size, width=CFG.width,
        depth=CFG.depth, heads=CFG.heads, embed_dim=CFG.embed_dim)
    monkeypatch.setattr(ctp.clip_text, "CLIPTextConfig", lambda: tcfg)
    monkeypatch.setattr(clip_vision, "CLIPVisionConfig", lambda: vcfg)
    zz = generate_zeroshot_graph_json()
    g = graph_from_json(zz)
    img = np.random.default_rng(0).random((3, 48, 40)).astype(np.float32)
    g.add_input(img, g.nodes[0], "o")
    out = Executor(reg).run(g, taps="primary")
    sim = next(i for i, nd in enumerate(zz["nodes"])
               if nd["instance"].get("endpoint") == "similarity")
    logits = np.asarray(out[sim]["o"])
    assert logits.shape == (1, len(DEFAULT_PROMPTS))
    assert np.isfinite(logits).all()
    # scaled cosine similarities of unit vectors stay within +-scale
    assert np.abs(logits).max() <= 100.0 + 1e-3


def test_prompt_rewording_hits_cached_program(reg_and_model):
    # prompt WORDING is a dynamic param: editing text must be a cache
    # hit (tokens/eot ride as runtime captures), and the values must
    # actually change the embedding
    reg, model = reg_and_model
    ex = Executor(reg)
    gobj = model.generate_graph_json()
    gobj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps(
        ["a photo of a cat", "a photo of a dog"])
    g = graph_from_json(gobj)
    last = len(gobj["nodes"]) - 1
    emb1 = np.asarray(ex.run(g, taps={(last, "o")})[last]["o"])
    assert not ex.last_stats.cache_hit

    gobj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps(
        ["a photo of a bird", "a photo of a dog"])
    g2 = graph_from_json(gobj)
    emb2 = np.asarray(ex.run(g2, taps={(last, "o")})[last]["o"])
    assert ex.last_stats.cache_hit, "rewording a prompt recompiled"
    assert not np.allclose(emb1[0], emb2[0]), "edited prompt did not move"
    np.testing.assert_allclose(emb1[1], emb2[1], atol=1e-6)

    # COUNT change = different capture shapes = different program
    gobj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps(
        ["one", "two", "three"])
    g3 = graph_from_json(gobj)
    out3 = np.asarray(ex.run(g3, taps={(last, "o")})[last]["o"])
    assert not ex.last_stats.cache_hit
    assert out3.shape[0] == 3


def test_prompt_rewording_batches_together(reg_and_model):
    # two sessions with the same prompt COUNT but different wording share
    # one vmapped program: tokens/eot stack per request, the embed table
    # broadcasts (dynamic_capture_keys) instead of stacking k copies
    reg, model = reg_and_model
    ex = Executor(reg)
    gobj = model.generate_graph_json()
    last = len(gobj["nodes"]) - 1

    def build(prompts):
        gobj["nodes"][0]["instance"]["params"]["prompts"] = json.dumps(
            prompts)
        return graph_from_json(gobj)

    ga = build(["a red square", "a blue circle"])
    gb = build(["a green triangle", "a blue circle"])
    outs = ex.run_stacked([ga, gb], taps={(last, "o")})
    assert len(outs) == 2
    # per-request truth from the single-run path
    want_a = np.asarray(Executor(reg).run(
        build(["a red square", "a blue circle"]),
        taps={(last, "o")})[last]["o"])
    want_b = np.asarray(Executor(reg).run(
        build(["a green triangle", "a blue circle"]),
        taps={(last, "o")})[last]["o"])
    np.testing.assert_allclose(
        np.asarray(outs[0][last]["o"]), want_a, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(outs[1][last]["o"]), want_b, atol=1e-5)
