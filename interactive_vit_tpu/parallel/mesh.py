"""Device mesh construction and ViT sharding rules.

The reference had NO distribution at all (SURVEY.md §2.3 — single Django
process, CPU torch); its only "transport" was the client<->server HTTP hop.
Scaling here is pure ``jax.sharding``: we declare a mesh and per-tensor
``NamedSharding``s, and XLA GSPMD inserts the collectives.

Mesh axes:
    data   — batch dimension (DP); gradients reduce over this axis
    model  — tensor parallelism (TP): attention heads / MLP hidden dim

ViT TP layout (the standard Megatron split, expressed declaratively):
    qkv_w  [D, 3D]    shard OUT dim  -> each chip holds H/model heads
    proj_w [D, D]     shard IN dim   -> psum after (GSPMD inserts it)
    fc1_w  [D, 4D]    shard OUT dim
    fc2_w  [4D, D]    shard IN dim
    everything else   replicated
Activations [B, N, D] are sharded on batch over "data"; within a block the
per-head tensors [B, H, N, Dh] become head-sharded over "model" because
the weights force it — PROVIDED the qkv columns are head-major.

The storage layout (torch-compatible, ``ops/attention.qkv_proj``) packs
the 3D output dim as [3][H][Dh] (all of Q, then K, then V): a flat shard
boundary at 3D/p never falls on head boundaries, so sharding it would
keep numerics correct but make GSPMD reshard the activation at the head
reshape instead of running head-parallel. ``permute_qkv_head_major``
re-packs the columns [H][3][Dh] (Megatron's layout) at mesh-setup time;
``qkv_proj(..., head_major=True)`` consumes it. Every mesh entry point
(sharded training, mesh serving) applies the pair together.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from interactive_vit_tpu.models.vit import Params


def make_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model[, stage]) mesh.

    Default: all devices on the data axis (pure DP) — the right default for
    ViT-B-scale models that fit on one chip. Pass e.g. ``{"data": 4,
    "model": 2}`` for DP x TP. A ``stage`` axis > 1 adds pipeline
    parallelism: the serving executor folds untapped block chains into a
    GPipe schedule over it (``parallel/pipeline.py``), and is only appended
    when requested so 2-axis consumers see the classic (data, model) mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = {"data": len(devices), "model": 1}
    names = ["data", "model"]
    shape = [axis_sizes.get("data", 1), axis_sizes.get("model", 1)]
    if axis_sizes.get("stage", 1) > 1:
        names.append("stage")
        shape.append(axis_sizes["stage"])
    unknown = set(axis_sizes) - {"data", "model", "stage"}
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    need = int(np.prod(shape))
    if need < len(devices):
        devices = devices[:need]  # a sub-mesh is fine; use the first chips
    if need != len(devices):
        raise ValueError(
            f"mesh {tuple(shape)} needs {need} devices, got {len(devices)}"
        )
    # the mesh follows the algorithm only: the devices of one host are
    # joined all to all, so enumeration order is as good as any
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, tuple(names))


def permute_qkv_head_major(params: Params, heads: int) -> Params:
    """Re-pack every block's qkv columns [3][H][Dh] -> [H][3][Dh].

    Makes the flat qkv output dim head-major so ``param_spec``'s
    P(None, "model") column sharding is head-ALIGNED (chip i holds heads
    [i*H/p, (i+1)*H/p) with their full q,k,v) — the actual Megatron
    split. Pair with ``ops/attention.qkv_proj(..., head_major=True)``.
    Dense f32/bf16 params only; apply BEFORE quantization.
    """
    import jax.numpy as jnp

    def repack_w(w):
        d = w.shape[0]
        dh = d // heads
        return (w.reshape(d, 3, heads, dh).transpose(0, 2, 1, 3)
                .reshape(d, 3 * d))

    def repack_b(b):
        d = b.shape[0] // 3
        dh = d // heads
        return (b.reshape(3, heads, dh).transpose(1, 0, 2)
                .reshape(3 * d))

    out = dict(params)
    out["blocks"] = [
        {**blk,
         "qkv_w": repack_w(jnp.asarray(blk["qkv_w"])),
         "qkv_b": repack_b(jnp.asarray(blk["qkv_b"]))}
        for blk in params["blocks"]
    ]
    return out


def unpermute_qkv_head_major(params: Params, heads: int) -> Params:
    """Inverse of ``permute_qkv_head_major``: [H][3][Dh] -> [3][H][Dh].

    Checkpoint exports must pass through this when training ran with TP:
    the on-disk canonical layout is the torch-style [3][H][Dh] packing
    (what every converter emits and the single-chip forward expects) —
    saving the training layout would silently mis-wire attention heads
    when the checkpoint is later served without TP."""
    import jax.numpy as jnp

    def unpack_w(w):
        d = w.shape[0]
        dh = d // heads
        return (w.reshape(d, heads, 3, dh).transpose(0, 2, 1, 3)
                .reshape(d, 3 * d))

    def unpack_b(b):
        d = b.shape[0] // 3
        dh = d // heads
        return (b.reshape(heads, 3, dh).transpose(1, 0, 2)
                .reshape(3 * d))

    out = dict(params)
    out["blocks"] = [
        {**blk,
         "qkv_w": unpack_w(jnp.asarray(blk["qkv_w"])),
         "qkv_b": unpack_b(jnp.asarray(blk["qkv_b"]))}
        for blk in params["blocks"]
    ]
    return out


def param_spec(path: str) -> P:
    """PartitionSpec for a ViT param, keyed by its pytree path leaf name.

    Weight-only int8 leaves (``ops/quant.py``) live one level deeper —
    ``.../qkv_w/int8_q`` ([D_in, D_out] like the dense weight) and
    ``.../qkv_w/int8_s`` ([D_out]) — and shard like their dense parent so
    quantized serving keeps the same TP layout.
    """
    if path.endswith("/int8_q") or path.endswith("/int8a8_q"):
        return param_spec(path[: path.rfind("/")])
    if path.endswith("/int8_s") or path.endswith("/int8a8_s"):
        parent = param_spec(path[: path.rfind("/")])
        # scale is per-OUTPUT-channel: sharded iff the weight's out dim is
        return P(parent[1]) if len(parent) == 2 else P()
    if path.endswith("exp_fc1_w") or path.endswith("exp_fc2_w"):
        # EP: experts shard over "model" — the dispatch einsum's [E,C,D]
        # buffers inherit the E-sharding and GSPMD inserts the token
        # all-to-all (models/moe.py)
        return P("model", None, None)
    if path.endswith("exp_fc1_b") or path.endswith("exp_fc2_b"):
        return P("model", None)
    if path.endswith("qkv_w") or path.endswith("fc1_w"):
        return P(None, "model")          # shard output features
    if path.endswith("qkv_b") or path.endswith("fc1_b"):
        return P("model")
    if path.endswith("proj_w") or path.endswith("fc2_w"):
        return P("model", None)          # shard input features
    return P()                            # replicate


def param_shardings(params: Params, mesh: Mesh):
    """NamedSharding pytree matching ``params``' structure.

    Subtrees under a ``__pp<i>`` key are layer-STACKED pipeline captures
    (executor PP folding): their leaves carry a leading layer dim sharded
    over "stage" (each stage holds its own blocks), rest replicated — the
    exact in_spec ``pipeline_apply``'s shard_map consumes, so no resharding
    happens at the shard_map boundary.
    """

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + "/" + k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            t = [walk(v, prefix + f"/{i}") for i, v in enumerate(tree)]
            return type(tree)(t)
        if "/__pp" in prefix:
            return NamedSharding(mesh, P("stage"))
        return NamedSharding(mesh, param_spec(prefix))

    return walk(params)


def shard_params(params: Params, mesh: Mesh) -> Params:
    """Place params onto the mesh per the TP layout."""
    return jax.device_put(params, param_shardings(params, mesh))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Inputs [B, ...]: batch over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
