"""VGG16 plugin: reference node-surface parity + torch CPU logits parity.

The strongest parity statement in the suite: the reference's OWN saved
``static/graphs/vgg16.json`` (42 nodes it generated for torch VGG16)
evaluates against this framework unmodified.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from interactive_vit_tpu.graph.executor import Executor
from interactive_vit_tpu.graph.registry import Registry
from interactive_vit_tpu.models import vgg
from interactive_vit_tpu.models.vgg_plugin import make_vgg16_model
from interactive_vit_tpu.ops.node_ops import register_builtin
from interactive_vit_tpu.wire.schema import graph_from_json

# the reference's own saved graphs, as committed copies in this repo
GRAPHS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "static", "graphs")


def torch_vgg16():
    """torchvision-architecture VGG16 with torchvision param names."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    layers, in_ch = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers.append(nn.Conv2d(in_ch, v, 3, padding=1))
            layers.append(nn.ReLU(inplace=False))
            in_ch = v
    model = nn.Sequential()
    model.features = nn.Sequential(*layers)
    model.avgpool = nn.AdaptiveAvgPool2d((7, 7))
    model.classifier = nn.Sequential(
        nn.Linear(25088, 4096), nn.ReLU(), nn.Dropout(0.0),
        nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(0.0),
        nn.Linear(4096, 1000),
    )

    def forward(x):
        x = model.features(x)
        x = model.avgpool(x)
        x = torch.flatten(x, 1)
        return model.classifier(x)

    model.forward = forward
    return model


@pytest.fixture(scope="module")
def setup():
    params = vgg.init_params(jax.random.key(0))
    model = make_vgg16_model(params=params)
    reg = Registry()
    register_builtin(reg)
    model.register(reg)
    return params, model, reg


def test_node_surface_matches_reference_graph(setup):
    """Every endpoint in the reference's saved vgg16.json is registered."""
    _, model, reg = setup
    with open(os.path.join(GRAPHS, "vgg16.json")) as f:
        obj = json.load(f)
    endpoints = [
        n["instance"]["endpoint"]
        for n in obj["nodes"]
        if n["instance"]["kind"] == "net_node"
    ]
    assert len(endpoints) == 41  # + 1 category sink = the 42-node graph
    for ep in endpoints:
        assert ep in reg, f"missing node kind {ep}"


def test_reference_vgg16_graph_evaluates(setup):
    _, model, reg = setup
    ex = Executor(reg)
    with open(os.path.join(GRAPHS, "vgg16.json")) as f:
        g = graph_from_json(json.load(f))
    img = np.random.default_rng(0).random((3, 64, 64)).astype(np.float32)
    g.add_input(img, g.nodes[0], "o")  # into vgg16:transform
    head_idx = next(n.index for n in g.nodes if n.name == "vgg16:classifier.6")
    out = ex.run(g, taps={(head_idx, "o")})
    logits = np.asarray(out[head_idx]["o"])
    assert logits.shape == (1000,)  # reference ran unbatched
    assert np.isfinite(logits).all()


def test_logits_parity_vs_torch(setup):
    params, _, _ = setup
    tm = torch_vgg16()
    sd = {}
    for idx in [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]:
        sd[f"features.{idx}.weight"] = np.asarray(params["features"][str(idx)]["w"])
        sd[f"features.{idx}.bias"] = np.asarray(params["features"][str(idx)]["b"])
    for idx in [0, 3, 6]:
        sd[f"classifier.{idx}.weight"] = np.asarray(
            params["classifier"][str(idx)]["w"]
        ).T
        sd[f"classifier.{idx}.bias"] = np.asarray(params["classifier"][str(idx)]["b"])
    tm.load_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=False
    )
    tm.eval()

    x = np.random.default_rng(1).random((2, 3, 64, 64)).astype(np.float32)
    ours = np.asarray(vgg.forward(params, jnp.asarray(x)))
    with torch.no_grad():
        theirs = tm.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_from_torchvision_converter(setup):
    tm = torch_vgg16()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = vgg.from_torchvision(sd)
    x = np.random.default_rng(2).random((1, 3, 64, 64)).astype(np.float32)
    ours = np.asarray(vgg.forward(params, jnp.asarray(x)))
    with torch.no_grad():
        theirs = tm.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)
