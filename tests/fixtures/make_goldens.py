"""Generate the committed golden fixtures in this directory.

Run manually (``python tests/fixtures/make_goldens.py``) when the fixture
format changes; the outputs are committed so the regression tests
(``tests/test_goldens.py``) never need torch or egress at test time.

What gets generated (the real-weights pipeline contract, VERDICT r1 #5):

* ``vit_golden_tv.safetensors`` — an ACTUAL checkpoint file in torchvision
  state-dict naming for a tiny ViT, written by our torch-free safetensors
  writer. The test exercises the whole file-to-logits path:
  safetensors read -> weights.from_torchvision -> vit.forward.
* ``vit_golden.npz`` — input images + the torch reference model's logits
  and per-layer attention maps for that checkpoint (the 1e-4 contract
  oracle, computed by tests/torch_vit_ref.py which matches torchvision
  vit_b_16 layer-for-layer).
* ``vgg16_golden.npz`` — input + torch-reference logits for the seeded
  deterministic VGG16 init (weights are NOT stored — 138M params — they
  regenerate from jax.random.key(11); if jax's RNG ever changes the test
  fails loudly and this script regenerates the fixture).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # tests/ for torch_vit_ref
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # repo root

import jax  # noqa: E402

# CPU-canonical fixtures, and never touch an accelerator (a second jax
# process preallocates device memory and starves whatever holds the card)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from interactive_vit_tpu.models import vgg, vit, weights  # noqa: E402
from interactive_vit_tpu.utils.safetensors_io import save_file  # noqa: E402
from torch_vit_ref import TorchViTRef  # noqa: E402

VIT_CFG = vit.ViTConfig("vit_golden", img_size=32, patch=16, width=64,
                        depth=2, heads=4, num_classes=10)


def gen_vit():
    params = vit.init_params(jax.random.key(7), VIT_CFG)
    sd = weights.to_torchvision(params, VIT_CFG)
    save_file(sd, os.path.join(HERE, "vit_golden_tv.safetensors"),
              metadata={"model": "vit_golden", "layout": "torchvision"})

    tm = TorchViTRef(VIT_CFG)
    tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    tm.eval()
    x = np.random.default_rng(3).random((2, 3, 32, 32)).astype(np.float32)
    logits, attn = tm(torch.from_numpy(x), need_weights=True)
    np.savez_compressed(
        os.path.join(HERE, "vit_golden.npz"),
        input=x, logits=logits.numpy(), attn=attn.numpy(),
    )
    print("vit golden:", logits.shape, attn.shape)


def gen_vgg():
    from test_vgg import torch_vgg16

    params = vgg.init_params(jax.random.key(11))
    tm = torch_vgg16()
    sd = {}
    for idx in [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]:
        sd[f"features.{idx}.weight"] = np.asarray(params["features"][str(idx)]["w"])
        sd[f"features.{idx}.bias"] = np.asarray(params["features"][str(idx)]["b"])
    for idx in [0, 3, 6]:
        sd[f"classifier.{idx}.weight"] = np.asarray(
            params["classifier"][str(idx)]["w"]).T
        sd[f"classifier.{idx}.bias"] = np.asarray(params["classifier"][str(idx)]["b"])
    tm.load_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=False)
    tm.eval()
    x = np.random.default_rng(5).random((2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        logits = tm.forward(torch.from_numpy(x)).numpy()
    np.savez_compressed(
        os.path.join(HERE, "vgg16_golden.npz"), input=x, logits=logits)
    print("vgg golden:", logits.shape)




def gen_vit_timm():
    """timm-layout golden (the DINO checkpoint family): the SAME tiny ViT
    weights re-expressed in timm naming, plus an INDEPENDENT torch
    timm-style module's logits (fused-qkv Linear + Conv2d patch embed run
    through torch itself, so the conv flattening order and every
    transpose in weights.from_timm are oracle-checked)."""
    import torch.nn as nn

    params = jax.device_get(vit.init_params(jax.random.key(7), VIT_CFG))
    cfg = VIT_CFG
    d, p = cfg.width, cfg.patch

    sd = {}
    sd["cls_token"] = np.asarray(params["cls_token"], np.float32)
    sd["pos_embed"] = np.asarray(params["pos_emb"], np.float32)
    sd["patch_embed.proj.weight"] = (
        np.asarray(params["patch_embed"]["w"], np.float32)
        .T.reshape(d, cfg.in_chans, p, p))
    sd["patch_embed.proj.bias"] = np.asarray(params["patch_embed"]["b"],
                                             np.float32)
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        sd[pre + "norm1.weight"] = np.asarray(blk["ln1_s"], np.float32)
        sd[pre + "norm1.bias"] = np.asarray(blk["ln1_b"], np.float32)
        sd[pre + "attn.qkv.weight"] = np.asarray(blk["qkv_w"], np.float32).T
        sd[pre + "attn.qkv.bias"] = np.asarray(blk["qkv_b"], np.float32)
        sd[pre + "attn.proj.weight"] = np.asarray(blk["proj_w"],
                                                  np.float32).T
        sd[pre + "attn.proj.bias"] = np.asarray(blk["proj_b"], np.float32)
        sd[pre + "norm2.weight"] = np.asarray(blk["ln2_s"], np.float32)
        sd[pre + "norm2.bias"] = np.asarray(blk["ln2_b"], np.float32)
        sd[pre + "mlp.fc1.weight"] = np.asarray(blk["fc1_w"], np.float32).T
        sd[pre + "mlp.fc1.bias"] = np.asarray(blk["fc1_b"], np.float32)
        sd[pre + "mlp.fc2.weight"] = np.asarray(blk["fc2_w"], np.float32).T
        sd[pre + "mlp.fc2.bias"] = np.asarray(blk["fc2_b"], np.float32)
    sd["norm.weight"] = np.asarray(params["norm"]["s"], np.float32)
    sd["norm.bias"] = np.asarray(params["norm"]["b"], np.float32)
    sd["head.weight"] = np.asarray(params["head"]["w"], np.float32).T
    sd["head.bias"] = np.asarray(params["head"]["b"], np.float32)
    save_file(sd, os.path.join(HERE, "vit_golden_timm.safetensors"),
              metadata={"model": "vit_golden", "layout": "timm"})

    class TimmBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
            self.attn = nn.Module()
            self.attn.qkv = nn.Linear(d, 3 * d)
            self.attn.proj = nn.Linear(d, d)
            self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
            self.mlp = nn.Module()
            self.mlp.fc1 = nn.Linear(d, cfg.mlp_dim)
            self.mlp.fc2 = nn.Linear(cfg.mlp_dim, d)

        def forward(self, x):
            b, n, _ = x.shape
            h = self.norm1(x)
            qkv = self.attn.qkv(h).reshape(b, n, 3, cfg.heads,
                                           d // cfg.heads)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            a = torch.softmax(
                q @ k.transpose(-2, -1) / (d // cfg.heads) ** 0.5, dim=-1)
            o = (a @ v).transpose(1, 2).reshape(b, n, d)
            x = x + self.attn.proj(o)
            return x + self.mlp.fc2(
                torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x))))

    class TimmViT(nn.Module):
        def __init__(self):
            super().__init__()
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.tokens, d))
            self.patch_embed = nn.Module()
            self.patch_embed.proj = nn.Conv2d(cfg.in_chans, d, p, stride=p)
            self.blocks = nn.ModuleList(
                [TimmBlock() for _ in range(cfg.depth)])
            self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)
            self.head = nn.Linear(d, cfg.num_classes)

        @torch.no_grad()
        def forward(self, images):
            b = images.shape[0]
            x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
            x = x + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            return self.head(self.norm(x)[:, 0])

    tm = TimmViT()
    tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    tm.eval()
    x = np.random.default_rng(3).random((2, 3, 32, 32)).astype(np.float32)
    logits = tm(torch.from_numpy(x)).numpy()
    np.savez_compressed(os.path.join(HERE, "vit_golden_timm.npz"),
                        input=x, logits=logits)
    print("vit timm golden:", logits.shape)


if __name__ == "__main__":
    gen_vit()
    gen_vit_timm()
    gen_vgg()
