"""Built-in graph node kinds (server-evaluable, jnp-traceable).

The reference ran these ops *client-side* in WebGPU WGSL shaders
(``/root/reference/main/static/main/nodes/*.js``) and only model layers on
the server. Here every op is a jnp function, so a whole saved graph — image
source through viewers — stages into one fused XLA program. That
realizes the reference's own roadmap item "server-side graph"
(``/root/reference/todo.md:13``) and removes the client<->server tensor
round-trips from the hot path.

Node kinds and their (de)serialized instance contracts:

  cos       params A, b           -> cos(A*x + b)         (main/nodes/cos.py)
  binop     op in {+,-,*,/}       elementwise              (nodes/binop.js:20-81)
  slice     fixed=[{dim,val}], free=[{in_dim,out_dim}]     (nodes/index.js:25-194)
  shuffle   free=[{in_dim,out_dim}] dimension permutation  (nodes/index.js:196-283)
  const     value, dims           filled tensor            (nodes/const.js:82-90)
  noise     dims, seed            uniform [0,1) tensor     (nodes/noise.js:21-28)
  conv2d    matrix (base64 f32), w, h   valid-pad 2-D conv (nodes/conv2d_node.js)
  resize    dims=[H,W]            bilinear CHW resize      (nodes/resize.js:129-130)
  pca_view  skip                  patch-PCA -> RGB (DINO dense-feature view)
  patch_sim row, col, skip        token cosine-similarity heatmap
  saliency  target, class, mode, steps, wrt   input-gradient attribution
            (jax.grad through the staged program; no reference analog —
            its server ran under torch.no_grad)
  occlusion target, class, patch, stride, fill, wrt   occlusion
            sensitivity (forward-only sliding-mask attribution as one
            lax.scan inside the staged program)
  img_src   identity (client binds the decoded image as input "o")
  img_view / multi_view / category   sinks: identity pass-through so taps can
            read what the client-side viewer would render
            (nodes/img_view_node.js, multi_view.js, category.js)

Params arrive stringly-typed (wire contract); JSON-valued params are JSON
strings (see ``wire/schema.graph_from_json``).
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.graph.registry import NodeKind, Registry


def _jparam(params: Dict[str, str], key: str, default):
    if key not in params:
        return default
    v = params[key]
    return json.loads(v) if isinstance(v, str) else v


def _num_input(name: str, value, step="any", title=None) -> str:
    """A labeled numeric input bound to a node param.

    The ``data-param`` convention is the server-delivered editable-UI
    contract (the reference served structured HTML bodies per node,
    ``/root/reference/main/context.py:90-92``; its conv matrix editor was
    client-only — here the server delivers it): the frontend binds any
    ``[data-param]`` element to the node's params dict and re-evaluates on
    change (``frontend/js/nodes.js`` NetNode.bindContents)."""
    import html as _html

    label = _html.escape(title or name)
    return (
        f"<label>{label} <input data-param=\"{_html.escape(name)}\" "
        f"type=\"number\" step=\"{step}\" value=\"{value}\"></label>"
    )


class CosNode(NodeKind):
    """Elementwise cos(A*x + b) — the reference's demo server node."""

    def __init__(self) -> None:
        super().__init__("cos")

    def decode_params(self, params):
        return float(params.get("A", 1.0)), float(params.get("b", 0.0))

    def contents(self, params):
        a, b = self.decode_params(params)
        return (f"<p>cos(A&middot;x + b)</p>"
                f"{_num_input('A', a)} {_num_input('b', b)}")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"A", "b"})

    def captures(self, params):
        a, b = self.decode_params(params)
        return {"A": np.float32(a), "b": np.float32(b)}

    def fn(self, params):
        def run(ins, caps):
            x = ins["o"]
            # cast the traced scalars to the stream dtype: strong-typed
            # f32 captures would promote a bf16 stream to f32 (doubling
            # tap bytes), where the old python-float constants were weak
            a = caps["A"].astype(x.dtype)
            b = caps["b"].astype(x.dtype)
            return {"o": jnp.cos(a * x + b)}

        return run


class BinOpNode(NodeKind):
    """Elementwise a OP b; channels a,b -> c (``binop.js:78-81``)."""

    OPS = {
        "+": jnp.add,
        "-": jnp.subtract,
        "*": jnp.multiply,
        "/": jnp.divide,
    }

    def __init__(self) -> None:
        super().__init__("binop")

    def contents(self, params):
        cur = params.get("op", "+")
        opts = "".join(
            f"<option value=\"{o}\"{' selected' if o == cur else ''}>"
            f"a {o} b</option>" for o in self.OPS
        )
        return f"<select data-param=\"op\">{opts}</select>"

    def io(self, params):
        return {"ins": ["a", "b"], "outs": ["c"]}

    def fn(self, params):
        op = self.OPS[params.get("op", "+")]
        return lambda ins: {"c": op(ins["a"], ins["b"])}


class _IndexNode(NodeKind):
    """Shared slice/shuffle logic (``nodes/index.js:25-62``).

    fixed: list of {dim, val} — input dims pinned to an index.
    free:  list of {in_dim, out_dim} — surviving dims, re-ordered so output
           dim ``out_dim`` reads input dim ``in_dim``.
    """

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def contents(self, params):
        fixed = _jparam(params, "fixed", [])
        free = _jparam(params, "free", [])
        n = len(fixed) + len(free)
        spec = ["?"] * n
        for f in fixed:
            if int(f["dim"]) < n:
                spec[int(f["dim"])] = str(int(f["val"]))
        for f in free:
            if int(f["in_dim"]) < n:
                spec[int(f["in_dim"])] = f"d{int(f['out_dim'])}"
        expr = ", ".join(spec) if spec else ":"
        return f"<p>{self.name}</p><code>y = x[{expr}]</code>"

    def fn(self, params):
        fixed = _jparam(params, "fixed", [])
        free = _jparam(params, "free", [])

        def run(ins):
            x = ins["o"]
            idx = [slice(None)] * x.ndim
            for f in fixed:
                idx[int(f["dim"])] = int(f["val"])
            y = x[tuple(idx)]
            # surviving input dims, ascending, map to positions 0..k-1
            kept = sorted(int(f["in_dim"]) for f in free)
            pos = {d: i for i, d in enumerate(kept)}
            perm = [0] * len(free)
            for f in free:
                perm[int(f["out_dim"])] = pos[int(f["in_dim"])]
            return {"o": jnp.transpose(y, perm) if perm else y}

        return run


class SliceNode(_IndexNode):
    def __init__(self) -> None:
        super().__init__("slice")


class ShuffleNode(_IndexNode):
    def __init__(self) -> None:
        super().__init__("shuffle")


class ConstNode(NodeKind):
    """Fill-value tensor of given dims (``const.js:82-90``)."""

    def __init__(self) -> None:
        super().__init__("const")

    def contents(self, params):
        import html as _html

        value = float(_jparam(params, "value", 0.0))
        dims = _jparam(params, "dims", [1])
        return (f"<p>const fill</p>{_num_input('value', value)} "
                f"<label>dims <input data-param=\"dims\" type=\"text\" "
                f"value=\"{_html.escape(json.dumps(dims))}\"></label>")

    def io(self, params):
        return {"ins": [], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"value"})

    def captures(self, params):
        return {"value": np.float32(float(_jparam(params, "value", 0.0)))}

    def fn(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [1])]
        return lambda ins, caps: {
            "o": jnp.full(dims, caps["value"], dtype=jnp.float32)
        }


class NoiseNode(NodeKind):
    """Uniform [0,1) tensor (``noise.js:21-28``).

    The reference used ``Math.random()`` host-side; here it is a pure
    ``jax.random`` op keyed by a ``seed`` param, so the node stays traceable
    and deterministic per compile. Re-randomizing = bumping the seed param
    — a DYNAMIC param delivered as a runtime capture, so it re-keys the
    cached program without recompiling (dims changes do recompile).
    """

    def __init__(self) -> None:
        super().__init__("noise")

    def contents(self, params):
        import html as _html

        dims = _jparam(params, "dims", [1])
        seed = int(float(params.get("seed", 0)))
        return (f"<p>uniform[0,1) noise</p>"
                f"<label>dims <input data-param=\"dims\" type=\"text\" "
                f"value=\"{_html.escape(json.dumps(dims))}\"></label> "
                f"{_num_input('seed', seed, step='1')}")

    def io(self, params):
        return {"ins": [], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"seed"})

    def captures(self, params):
        # mask into u32 range: the UI's number input reaches -1 with one
        # down-click, and np.uint32(-1) raises on NumPy 2
        seed = int(float(params.get("seed", 0))) & 0xFFFFFFFF
        return {"seed": np.uint32(seed)}

    def fn(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [1])]
        return lambda ins, caps: {
            "o": jax.random.uniform(jax.random.key(caps["seed"]), dims,
                                    dtype=jnp.float32)
        }


class Conv2dNode(NodeKind):
    """Single-channel 2-D convolution, valid padding.

    Matches the WGSL kernel semantics (``conv2d_node.js:5-31,175-178``):
    input [C,H,W] or [H,W]; each channel convolved with the same k x k
    matrix; output spatial dims shrink by 2*(k//2). The matrix travels
    base64-encoded f32 (``conv2d_node.js:214-227``). This lowers to one
    XLA conv.
    """

    def __init__(self) -> None:
        super().__init__("conv2d")

    def contents(self, params):
        # the editable k x k matrix, server-delivered (the reference's
        # richest node UI, client-rendered there: conv2d_node.js:107-139).
        # The frontend re-encodes edited cells to the base64 matrix param.
        m = self._matrix(params)
        h, w = m.shape
        rows = "".join(
            "<tr>" + "".join(
                f"<td><input data-cell=\"{i},{j}\" type=\"number\" "
                f"step=\"any\" value=\"{m[i, j]:g}\"></td>"
                for j in range(w)
            ) + "</tr>"
            for i in range(h)
        )
        return (f"<p>conv2d {h}&times;{w} (valid)</p>"
                f"{_num_input('h', h, step='1')} "
                f"{_num_input('w', w, step='1')}"
                f"<table data-matrix data-h=\"{h}\" data-w=\"{w}\">"
                f"{rows}</table>")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def _matrix(self, params) -> np.ndarray:
        h = int(float(params.get("h", 3)))
        w = int(float(params.get("w", 3)))
        if "matrix" in params:
            raw = base64.b64decode(params["matrix"])
            m = np.frombuffer(raw, dtype="<f4").reshape(h, w).copy()
        else:
            m = np.zeros((h, w), dtype=np.float32)
            m[h // 2, w // 2] = 1.0
        return m

    def dynamic_params(self):
        # matrix edits are the hottest interactive gesture (drag a cell):
        # the values ride as a runtime capture, so each edit re-keys the
        # cached program; only h/w changes (shape!) recompile
        return frozenset({"matrix"})

    def captures(self, params):
        return {"m": np.asarray(self._matrix(params))}

    def fn(self, params):
        def run(ins, caps):
            m = caps["m"]
            x = ins["o"]
            squeeze = x.ndim == 2
            if squeeze:
                x = x[None]
            # [C,H,W] -> depthwise-style conv with one shared kernel:
            # treat channels as batch, single in/out feature.
            lhs = x[:, None, :, :]  # [C,1,H,W]
            rhs = m[None, None, :, :]  # [1,1,kh,kw]
            from interactive_vit_tpu.ops.layers import mm_precision

            y = jax.lax.conv_general_dilated(
                lhs,
                rhs,
                window_strides=(1, 1),
                padding="VALID",
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
                # single-source precision policy (CLAUDE.md trap #4):
                # HIGHEST only for f32 inputs, native DEFAULT for bf16
                precision=mm_precision(lhs, rhs),
                preferred_element_type=jnp.float32,
            )[:, 0]
            return {"o": y[0] if squeeze else y}

        return run


class ResizeNode(NodeKind):
    """Bilinear CHW resize to dims=[H,W] (``resize.js:129-130``)."""

    def __init__(self) -> None:
        super().__init__("resize")

    def contents(self, params):
        import html as _html

        dims = [int(d) for d in _jparam(params, "dims", [224, 224])]
        return (f"<p>bilinear resize</p>"
                f"<label>dims <input data-param=\"dims\" type=\"text\" "
                f"value=\"{_html.escape(json.dumps(dims))}\"></label>")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [224, 224])]

        def run(ins):
            x = ins["o"]
            # resize the trailing two (spatial) dims whatever the rank:
            # CHW from the reference contract, and batched [B,C,H,W] maps
            # from pca_view/patch_sim wire in directly
            shape = (*x.shape[:-2], dims[0], dims[1])
            return {"o": jax.image.resize(x, shape, method="bilinear")}

        return run


def _token_grid(x, skip: int):
    """[B,N,D] (or [N,D]) tokens -> (patch tokens [B,P,D], side g).

    Drops the first ``skip`` tokens (CLS), requires the remainder to tile a
    square patch grid (every ViT variant here does: N = (img/patch)^2 + 1).
    Channels-last SPATIAL features [B,H,W,C] (swin stage outputs) flatten
    to their H*W token cloud directly — no CLS exists, so ``skip`` does
    not apply. Shape math is trace-time, so a bad wiring fails fast with
    a clear message instead of a cryptic reshape error inside XLA.
    """
    if x.ndim == 2:
        x = x[None]
    if x.ndim == 4:
        b, h, w, c = x.shape
        if h != w or h < 2:
            raise ValueError(
                f"spatial features must be square [B,H,W,C], got {x.shape}"
            )
        return x.reshape(b, h * w, c).astype(jnp.float32), h
    if x.ndim != 3:
        raise ValueError(
            f"expected token sequence [B,N,D] or [N,D], got shape {x.shape}"
        )
    if not 0 <= skip < x.shape[1]:
        raise ValueError(
            f"skip={skip} out of range for {x.shape[1]} tokens"
        )
    p = x.shape[1] - skip
    g = int(round(p ** 0.5))
    if g * g != p or g < 2:
        raise ValueError(
            f"{p} patch tokens (after skipping {skip}) do not tile a "
            f"square grid — wire a ViT token sequence ('o' of a block or "
            f"norm node)"
        )
    return x[:, skip:].astype(jnp.float32), g


def _pca_top3(cov: "jnp.ndarray", prec, iters: int = 96,
              k: int = 6) -> "jnp.ndarray":
    """Top-3 eigenvectors of batched SPD ``cov`` [B,D,D], eigenvalue-ordered.

    Simultaneous (subspace) iteration with modified-Gram-Schmidt
    orthonormalization — matmuls + elementwise only. ``jnp.linalg.eigh``
    is deliberately NOT used: its QDWH lowering on this backend costs
    minutes of compile and an iteration-heavy device loop that dominated
    interactive serving (measured 2026-08-16: the eigh probe blew a 400 s
    trace budget; this formulation traces in milliseconds).

    Orthonormalization runs after EVERY power step: deferring it (N
    unnormalized multiplies per MGS pass) amplifies the eigen-spread to
    (lambda_1/lambda_k)^N, and past f32's 2^24 the MGS cancellation
    residual of a trailing column points along PC1 instead of its own
    direction — measured: a junk column froze at 0.86 alignment with PC1
    with an inflated Rayleigh quotient. For the same reason the output is
    columns 0..2 directly (subspace iteration's fixed point assigns
    column c the c-th eigendirection), not a Rayleigh-quotient re-sort a
    corrupted trailing column could win. ``k`` extra columns absorb slow
    convergence and eigenvalue clusters.
    """
    bsz, d, _ = cov.shape
    # deterministic full-rank start: d x k slice of a fixed rotation-ish
    # basis (iota-seeded cosines), shared across the batch
    i = jnp.arange(d, dtype=jnp.float32)[:, None]
    j = jnp.arange(k, dtype=jnp.float32)[None, :]
    q0 = jnp.cos(i * (j + 1.0) * 0.573 + j)  # [D,k], incoherent columns
    q = jnp.broadcast_to(q0[None], (bsz, d, k)).astype(cov.dtype)

    def orthonormalize(q):
        cols = []
        for c in range(k):
            v = q[..., c]
            for u in cols:
                v = v - u * jnp.sum(u * v, axis=-1, keepdims=True)
            v = v / jnp.maximum(
                jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
            cols.append(v)
        return jnp.stack(cols, axis=-1)

    def body(q, _):
        q = jnp.einsum("bde,bek->bdk", cov, q, precision=prec)
        return orthonormalize(q), None

    q = orthonormalize(q)
    q, _ = jax.lax.scan(body, q, None, length=iters)
    return q[..., :3]


class PcaViewNode(NodeKind):
    """Patch-token PCA -> RGB image: the DINO/DINOv2 dense-feature view.

    The classic self-supervised-ViT visualization (Caron et al. 2021;
    Oquab et al. 2023): project every patch token onto the top-3 principal
    components of the image's own token cloud, map components to RGB.
    Input "o": tokens [B,N,D] from any block/norm node, or channels-last
    spatial features [B,H,W,C] (swin stage outputs — flattened to their
    H*W token cloud; no CLS, so ``skip`` does not apply). Output "o":
    [B,3,g,g] in [0,1], viewable directly in ``img_view`` and resizable
    with the builtin ``resize`` node.

    Notes: the covariance is a [D,D] einsum and the top-3 directions come
    from matmul-only subspace iteration (``_pca_top3``) — XLA's eigh is
    avoided on purpose (long compiles and an iteration-heavy device loop
    on the backend this was first built for). The whole view
    stages into the same program as the model, so toggling it costs one
    tap recompile, not a host round-trip. No reference analog (its viewers
    were client-side canvas composites, ``nodes/multi_view.js``); this
    realizes the same "splice a viewer onto any edge" contract for dense
    features.
    """

    def __init__(self) -> None:
        super().__init__("pca_view")

    def contents(self, params):
        skip = int(float(params.get("skip", 1)))
        return ("<p>patch-PCA &rarr; RGB (DINO-style)</p>"
                + _num_input("skip", skip, step="1",
                             title="tokens to skip (CLS)"))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        skip = int(float(params.get("skip", 1)))

        def run(ins):
            from interactive_vit_tpu.ops.layers import mm_precision

            t, g = _token_grid(ins["o"], skip)
            b, p, _ = t.shape
            t = t - t.mean(axis=1, keepdims=True)
            prec = mm_precision(t)
            cov = jnp.einsum("bpd,bpe->bde", t, t, precision=prec) / p
            top3 = _pca_top3(cov, prec)  # [B,D,3], PC1 first
            proj = jnp.einsum("bpd,bdc->bpc", t, top3, precision=prec)
            lo = proj.min(axis=1, keepdims=True)
            hi = proj.max(axis=1, keepdims=True)
            img = (proj - lo) / jnp.maximum(hi - lo, 1e-8)
            return {"o": img.transpose(0, 2, 1).reshape(b, 3, g, g)}

        return run


class PatchSimNode(NodeKind):
    """Cosine similarity of one query token vs every patch -> heatmap.

    Input "o": tokens [B,N,D], or channels-last spatial features
    [B,H,W,C] (swin stages; no CLS — negative row/col falls back to
    patch (0,0)). Params ``row``/``col`` select the query
    patch on the g x g grid; either negative (the default) queries the CLS
    token instead — the "what is the image about" saliency view. Output
    "o": [B,3,g,g] grayscale (similarity rescaled from [-1,1] to [0,1],
    replicated to 3 channels so ``img_view``/``resize`` consume it
    directly). ``row``/``col`` are DYNAMIC params (runtime captures, out
    of the compile signature), so scrubbing the query across the grid
    re-keys the cached program — no recompile; ``skip`` changes shapes
    and does recompile.
    """

    def __init__(self) -> None:
        super().__init__("patch_sim")

    def contents(self, params):
        row = int(float(params.get("row", -1)))
        col = int(float(params.get("col", -1)))
        skip = int(float(params.get("skip", 1)))
        return ("<p>token cosine-similarity heatmap</p>"
                + _num_input("row", row, step="1",
                             title="query row (-1 = token 0/CLS)")
                + " " + _num_input("col", col, step="1",
                                   title="query col (-1 = token 0/CLS)")
                + " " + _num_input("skip", skip, step="1",
                                   title="tokens to skip (CLS)"))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def dynamic_params(self):
        # scrubbing the query across the grid is THE interaction; row/col
        # ride as runtime captures so each scrub re-keys the cached
        # program — no recompile (skip changes shapes and does recompile)
        return frozenset({"row", "col"})

    def captures(self, params):
        return {"row": np.int32(int(float(params.get("row", -1)))),
                "col": np.int32(int(float(params.get("col", -1))))}

    def fn(self, params):
        skip = int(float(params.get("skip", 1)))

        def run(ins, caps):
            from interactive_vit_tpu.ops.layers import mm_precision

            x = ins["o"]
            if x.ndim == 2:
                x = x[None]
            if x.ndim == 4:
                # spatial features (swin): no CLS token, skip n/a; the
                # "token 0" fallback below is patch (0,0) of the grid
                t, g = _token_grid(x, 0)
                x = t
            else:
                t, g = _token_grid(x, skip)
            b = t.shape[0]
            row, col = caps["row"], caps["col"]
            # traced query select: patch (row, col), clamped to the grid;
            # either negative -> token 0 (the CLS token when skip>=1; with
            # skip=0 this is patch (0,0) — the contents label says so)
            idx = (jnp.clip(row, 0, g - 1) * g + jnp.clip(col, 0, g - 1))
            q_patch = jnp.take(t, idx, axis=1).astype(jnp.float32)
            q_tok0 = x[:, 0].astype(jnp.float32)
            use_tok0 = jnp.logical_or(row < 0, col < 0)
            q = jnp.where(use_tok0, q_tok0, q_patch)
            qn = q / jnp.maximum(
                jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-8)
            tn = t / jnp.maximum(
                jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-8)
            sim = jnp.einsum("bpd,bd->bp", tn, qn,
                             precision=mm_precision(tn))
            img = ((sim + 1.0) * 0.5).reshape(b, 1, g, g)
            return {"o": jnp.broadcast_to(img, (b, 3, g, g))}

        return run


class IdentityNode(NodeKind):
    """Pass-through; used for sources/sinks whose rendering is client-side.

    ``optional=True`` -> viewer semantics: any subset of the declared
    inputs may be wired (the executor skips the missing-input check)."""

    def __init__(self, name: str, ins: List[str], outs: List[str],
                 optional: bool = False):
        super().__init__(name)
        self._ins = ins
        self._outs = outs
        if optional:
            self.optional_inputs = True

    def io(self, params):
        return {"ins": self._ins, "outs": self._outs}

    def fn(self, params):
        ins_names, outs_names = self._ins, self._outs

        def run(ins):
            if not outs_names:
                return {}
            if len(ins_names) == 1 and len(outs_names) == 1:
                return {outs_names[0]: ins[ins_names[0]]}
            return {ch: ins[ch] for ch in outs_names if ch in ins}

        return run


class SimilarityNode(NodeKind):
    """Scaled cosine-similarity logits between two embedding sets.

    The zero-shot classification join: ``a`` [B, D] (or [D]) image
    embeddings x ``b`` [P, D] text embeddings -> ``o`` [B, P] logits
    (squeezed to [P] for a single image, which is what the ``category``
    sink displays). Both sides are L2-normalized here, so the node is
    robust to arbitrary upstream embeddings; ``scale`` defaults to 100.0
    (the published CLIP checkpoints' learned logit_scale.exp() ~= 100).

    No reference analog (the reference app is single-modal,
    ``/root/reference/static/models/vgg16.py``); params follow the stringly
    node-param wire contract (``/root/reference/main/graph.py:7-10``).
    """

    def __init__(self) -> None:
        super().__init__("similarity")

    def contents(self, params):
        scale = float(params.get("scale", 100.0))
        return (f"<p>zero-shot similarity<br>"
                f"scale &middot; (a&#775; &middot; b&#775;&#7488;)</p>"
                f"{_num_input('scale', scale)}")

    def io(self, params):
        return {"ins": ["a", "b"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"scale"})

    def captures(self, params):
        return {"scale": np.float32(float(params.get("scale", 100.0)))}

    def fn(self, params):
        def run(ins, caps):
            from interactive_vit_tpu.ops.layers import mm_precision

            a, b = ins["a"], ins["b"]
            squeeze = a.ndim == 1
            if squeeze:
                a = a[None]
            # norm clamp: a zero embedding (e.g. a const-0 node wired
            # in) must yield zero similarity, not NaN logits — same
            # guard as patch_sim/pca_view
            a = a / jnp.maximum(
                jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
            b = b / jnp.maximum(
                jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
            logits = jnp.einsum(
                "bd,pd->bp", a, b, preferred_element_type=jnp.float32,
                precision=mm_precision(a, b),
            ) * caps["scale"].astype(jnp.float32)
            logits = logits.astype(ins["a"].dtype)
            return {"o": logits[0] if squeeze else logits}

        return run


class _GradNode(NodeKind):
    """Shared base for gradient node kinds (saliency, dream).

    The executor contract (``graph/executor._grad_specs``): ``grad_node``
    kinds receive their ancestor cone as a closed function and implement
    ``grad_fn(params) -> run(forward, x, caps)``. This base owns the
    pieces that must not drift between kinds: the wrt-leaf spec parser
    and the scalar-target reduction."""

    grad_node = True
    TARGETS = ("max", "sum", "class")

    def grad_wrt(self, params):
        """("input", k) or ("node", idx, channel)."""
        w = str(params.get("wrt", "0"))
        if w.startswith("node:"):
            parts = w.split(":")
            if len(parts) == 2:
                return ("node", int(parts[1]), "o")
            if len(parts) == 3:
                return ("node", int(parts[1]), parts[2])
            raise ValueError(f"bad wrt spec {w!r} (node:<i> or "
                             f"node:<i>:<ch>)")
        return ("input", int(float(w)))

    def _check_target(self, target: str) -> str:
        if target not in self.TARGETS:
            raise ValueError(f"target must be one of {self.TARGETS}, "
                             f"got {target!r}")
        return target

    @staticmethod
    def _scalar_fn(forward, target, caps):
        """The differentiated objective: reduce the wired tensor to one
        scalar (per-sample, summed over the batch — samples independent)."""

        def scalar(xv):
            y = forward(xv).astype(jnp.float32)
            if target == "class":
                c = jnp.clip(caps["class"], 0, y.shape[-1] - 1)
                y = jnp.take(y, c, axis=-1)
            elif target == "max":
                y = jnp.max(y, axis=-1)
            return jnp.sum(y)

        return scalar

    @staticmethod
    def _sel_html(name, options, cur):
        import html as _html

        opts = "".join(
            f"<option value=\"{o}\"{' selected' if o == cur else ''}>"
            f"{o}</option>" for o in options)
        return (f"<label>{_html.escape(name)} <select data-param="
                f"\"{_html.escape(name)}\">{opts}</select></label>")

    @staticmethod
    def _wrt_html(params):
        import html as _html

        wrt = _html.escape(str(params.get("wrt", "0")))
        return ("<label>wrt <input data-param=\"wrt\" type=\"text\" "
                f"value=\"{wrt}\" size=\"9\" "
                "title=\"input index, or node:&lt;i&gt;[:&lt;ch&gt;] "
                "for an upstream activation\"></label>")


class SaliencyNode(_GradNode):
    """Input-gradient saliency: d(scalar of the wired tensor)/d(graph input).

    A capability class the reference could not express: its server ran
    every node under ``torch.no_grad()`` on CPU
    (``/root/reference/main/context.py:79-88``), so no gradient ever
    existed anywhere in the system. Here the staged executor re-traces the
    node's ancestor cone as a closed function of one graph input and
    ``jax.grad``s it INSIDE the same jitted program — forward pass,
    backward pass, and heatmap render fuse into one XLA program, and the
    backward matmuls run on the device like everything else.

    Wiring: input "o" is any tensor downstream of the image — typically
    the classifier logits (``vit_*:head``) or an embedding. Outputs:
    "o" = input-shaped normalized heatmap (abs-max over the channel axis,
    per-sample max-normalized, broadcast back to 3 channels) — wire it
    straight into ``img_view``/``overlay``; "g" = the raw attribution
    (input-shaped f32, extra channel: ships only when wired or tapped).

    Params (stringly, wire contract ``/root/reference/main/graph.py:7-10``):
      target  max | sum | class  scalar reduced from the wired tensor
                                 (per-sample, summed over the batch — each
                                 sample's gradient is independent)
      class   int                class index for target=class. DYNAMIC:
                                 scrubbing classes re-keys the cached
                                 program — no recompile.
      mode    grad | gradxinput | ig | smooth   attribution method;
                                 ig = integrated gradients on the
                                 zero-baseline path; smooth = SmoothGrad
                                 (mean gradient over noisy samples)
      steps   int (default 16)   IG path resolution / SmoothGrad sample
                                 count (static: a lax.scan length)
      sigma   float (default .15) SmoothGrad noise scale relative to the
                                 input range. DYNAMIC.
      seed    int (default 0)    SmoothGrad noise seed. DYNAMIC.
      wrt     "0" (default)      the leaf to differentiate: an integer
              | "node:<i>"       indexes the graph's input edges; or an
              | "node:<i>:<ch>"  upstream node's output — the Grad-CAM
                                 case: d(class logit)/d(tokens at block i),
                                 token-shaped attributions rendered as a
                                 patch-grid heatmap
      skip    int (default 1)    leading tokens dropped from the grid
                                 render of token-shaped ([B,N,D])
                                 attributions (CLS token, like patch_sim)

    Note on node-wrt targets: differentiate against a block that still
    has token MIXING downstream (any earlier block). Against the LAST
    block's output, only the CLS token reaches the classifier head, so
    every patch token's gradient is exactly zero and the heatmap is
    black — correct, but rarely what a user wants.
    """

    MODES = ("grad", "gradxinput", "ig", "smooth")

    def __init__(self) -> None:
        super().__init__("saliency")

    def contents(self, params):
        target = params.get("target", "max")
        mode = params.get("mode", "grad")
        sel = self._sel_html

        return ("<p>input-gradient saliency</p>"
                + sel("target", self.TARGETS, target) + " "
                + _num_input("class", int(float(params.get("class", 0))),
                             step="1", title="class (target=class)")
                + "<br>" + sel("mode", self.MODES, mode) + " "
                + _num_input("steps", int(float(params.get("steps", 16))),
                             step="1", title="IG / SmoothGrad steps")
                + " " + _num_input(
                    "sigma", float(params.get("sigma", 0.15)),
                    title="smooth noise (rel. to input range)")
                + "<br>" + self._wrt_html(params) + " "
                + _num_input("skip", int(float(params.get("skip", 1))),
                             step="1", title="CLS tokens to skip"))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "g"]}

    def extra_outs(self, params):
        return ["g"]

    def dynamic_params(self):
        # scrubbing the class index (and SmoothGrad's noise scale/seed) is
        # the interaction; they ride as runtime captures — no recompile
        return frozenset({"class", "sigma", "seed"})

    def captures(self, params):
        return {"class": np.int32(int(float(params.get("class", 0)))),
                "sigma": np.float32(float(params.get("sigma", 0.15))),
                "seed": np.int32(int(float(params.get("seed", 0))))}

    def _decode(self, params):
        target = self._check_target(params.get("target", "max"))
        mode = params.get("mode", "grad")
        steps = int(float(params.get("steps", 16)))
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        return target, mode, steps

    @staticmethod
    def _token_cam(attr, skip: int):
        """[B,N,D] token attribution -> [B,3,g,g] patch-grid heatmap.

        Per-token importance = L1 norm of the attribution over the
        feature dim, per-sample max-normalized, on the same patch grid
        rules as patch_sim. NOT the classic signed CAM sum: transformer
        blocks feed a LayerNorm, which makes the logit nearly
        scale-invariant in the block output, so the signed inner product
        x·∇f(x) is ~0 identically (measured ~1e-7 vs 1e0 magnitudes) —
        magnitude is the render that carries information here."""
        t, g = _token_grid(attr, skip)
        cam = jnp.sum(jnp.abs(t), axis=-1)
        cam = cam / jnp.maximum(
            jnp.max(cam, axis=-1, keepdims=True), 1e-12)
        img = cam.reshape(cam.shape[0], 1, g, g)
        return jnp.broadcast_to(img, (cam.shape[0], 3, g, g))

    def _heat(self, attr, skip: int, node_wrt: bool = False):
        """Render the attribution for img_view/overlay.

        Token streams ([B,N,D] whose N-skip tiles a square grid) render as
        a Grad-CAM patch heatmap; CHW-looking tensors abs -> channel-
        collapse -> per-sample max-normalize -> broadcast back to 3
        channels; anything else normalizes |attr| in place.

        ``node_wrt``: the leaf is an UPSTREAM NODE's output, which is
        always batch-leading and never channel-planar — without the hint
        a [1, N, D] token attribution whose N-skip isn't a square grid
        would pattern-match the CHW rules and collapse its BATCH axis."""
        if attr.ndim == 3:
            try:
                return self._token_cam(attr, skip)
            except ValueError:
                pass  # not a token grid — fall through to image rules
        h = jnp.abs(attr)
        chw = (not node_wrt) and h.ndim >= 3 and h.shape[-3] in (1, 3)
        if chw:
            h = jnp.max(h, axis=-3, keepdims=True)
        # per-sample normalization for batched/image-like tensors
        # (rank >= 3); global below that (a bare matrix has no batch dim)
        reduce_axes = tuple(range(1, h.ndim)) if h.ndim >= 3 else None
        m = jnp.max(h, axis=reduce_axes, keepdims=True) \
            if reduce_axes else jnp.max(h)
        h = h / jnp.maximum(m, 1e-12)
        if chw:
            h = jnp.broadcast_to(h, h.shape[:-3] + (3,) + h.shape[-2:])
        return h

    def grad_fn(self, params):
        target, mode, steps = self._decode(params)
        skip = int(float(params.get("skip", 1)))
        node_wrt = self.grad_wrt(params)[0] == "node"

        def run(forward, x, caps):
            scalar = self._scalar_fn(forward, target, caps)
            xf = x.astype(jnp.float32)
            if mode == "ig":
                alphas = (jnp.arange(steps, dtype=jnp.float32) + 1.0) / steps

                def body(acc, a):
                    g = jax.grad(scalar)((xf * a).astype(x.dtype))
                    return acc + g.astype(jnp.float32), None

                tot, _ = jax.lax.scan(
                    body, jnp.zeros(x.shape, jnp.float32), alphas)
                attr = (tot / steps) * xf
            elif mode == "smooth":
                # SmoothGrad: mean gradient over `steps` noisy samples,
                # noise scaled by sigma * input range (the published
                # construction); sigma/seed are dynamic — scrubbing the
                # noise scale re-keys the cached program
                key = jax.random.key(caps["seed"].astype(jnp.uint32))
                # PER-SAMPLE input range (the published construction):
                # a batch-global range would couple each sample's
                # attribution to its batchmates. Batch-leading is known
                # for node-wrt leaves and rank>=4 inputs; a rank<=3
                # graph input is a single unbatched image/value.
                if node_wrt or xf.ndim >= 4:
                    r_axes = tuple(range(1, xf.ndim))
                    rng_ = (jnp.max(xf, r_axes, keepdims=True)
                            - jnp.min(xf, r_axes, keepdims=True))
                else:
                    rng_ = jnp.max(xf) - jnp.min(xf)
                scale = caps["sigma"].astype(jnp.float32) * rng_

                def nbody(acc, i):
                    eps = jax.random.normal(
                        jax.random.fold_in(key, i), x.shape, jnp.float32)
                    g = jax.grad(scalar)((xf + scale * eps).astype(x.dtype))
                    return acc + g.astype(jnp.float32), None

                tot, _ = jax.lax.scan(
                    nbody, jnp.zeros(x.shape, jnp.float32),
                    jnp.arange(steps))
                attr = tot / steps
            else:
                g = jax.grad(scalar)(x).astype(jnp.float32)
                attr = g * xf if mode == "gradxinput" else g
            return {"o": self._heat(attr, skip, node_wrt).astype(x.dtype),
                    "g": attr}

        return run

    def fn(self, params):
        self._decode(params)  # surface param errors with node attribution
        raise NotImplementedError(
            "saliency differentiates through the WHOLE upstream graph — "
            "it has no per-node function; evaluate via the staged executor"
        )

    def compute(self, params, inputs):
        # eager debug paths isolate this as a per-node error and keep
        # evaluating the rest of the graph (run_eager fault isolation)
        self.fn(params)


class DreamNode(_GradNode):
    """Feature visualization by gradient ASCENT on the input.

    Optimizes the wrt leaf (default: the image) to maximize the scalar
    target of the wired tensor — "what does class k look like to this
    model" — as a ``lax.scan`` of normalized gradient-ascent steps INSIDE
    the staged program: the whole optimization loop is one XLA program on
    the device, not a host-side training loop. Another capability class the
    reference could not express (``torch.no_grad`` server,
    ``/root/reference/main/context.py:79-88``).

    Wiring: input "o" = the objective tensor (typically logits); output
    "o" = the optimized leaf (image-shaped — wire into img_view);
    "delta" = optimized minus original, f32 (extra channel).

    Params: ``target``/``class``/``wrt`` as saliency; ``steps`` ascent
    steps (static: scan length); ``lr`` step size in input-range units
    (DYNAMIC — scrub it live); ``clip_lo``/``clip_hi`` clamp the iterate
    (default 0..1, the image box; "none" disables).
    """

    def __init__(self) -> None:
        super().__init__("dream")

    def contents(self, params):
        target = params.get("target", "class")
        return ("<p>gradient-ascent feature visualization</p>"
                + self._sel_html("target", self.TARGETS, target) + " "
                + _num_input("class", int(float(params.get("class", 0))),
                             step="1", title="class (target=class)")
                + "<br>" + _num_input(
                    "steps", int(float(params.get("steps", 32))),
                    step="1", title="ascent steps")
                + " " + _num_input("lr", float(params.get("lr", 0.05)),
                                   title="step size")
                + "<br>" + self._wrt_html(params))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "delta"]}

    def extra_outs(self, params):
        return ["delta"]

    def dynamic_params(self):
        # scrubbing the step size / class live is the interaction
        return frozenset({"class", "lr"})

    def captures(self, params):
        return {"class": np.int32(int(float(params.get("class", 0)))),
                "lr": np.float32(float(params.get("lr", 0.05)))}

    def _decode(self, params):
        target = self._check_target(params.get("target", "class"))
        steps = int(float(params.get("steps", 32)))
        if steps < 1:
            raise ValueError("steps must be >= 1")

        def clip_of(key, default):
            v = str(params.get(key, default))
            return None if v == "none" else float(v)

        return target, steps, clip_of("clip_lo", "0"), clip_of("clip_hi", "1")

    def grad_fn(self, params):
        target, steps, clip_lo, clip_hi = self._decode(params)

        def run(forward, x, caps):
            scalar = self._scalar_fn(forward, target, caps)
            lr = caps["lr"].astype(jnp.float32)

            def body(xv, _):
                g = jax.grad(scalar)(xv).astype(jnp.float32)
                # normalized ascent: step size in input units regardless
                # of gradient magnitude (the standard feature-vis recipe)
                norm = jnp.sqrt(jnp.mean(jnp.square(g))) + 1e-12
                nxt = xv.astype(jnp.float32) + lr * g / norm
                if clip_lo is not None or clip_hi is not None:
                    nxt = jnp.clip(nxt, clip_lo, clip_hi)
                return nxt.astype(xv.dtype), None

            xo, _ = jax.lax.scan(body, x, None, length=steps)
            return {"o": xo,
                    "delta": xo.astype(jnp.float32) - x.astype(jnp.float32)}

        return run

    def fn(self, params):
        self._decode(params)
        raise NotImplementedError(
            "dream optimizes through the WHOLE upstream graph — staged "
            "executor only")

    def compute(self, params, inputs):
        self.fn(params)


class OcclusionNode(_GradNode):
    """Occlusion sensitivity: score drop under a sliding occluder.

    The classic forward-only attribution (Zeiler & Fergus): slide a
    ``patch``x``patch`` occluder over the wrt image at ``stride``,
    re-evaluate the wired scalar for each position, and render how much
    the score DROPS when each region is hidden. Shares the gradient
    nodes' replay contract (the executor hands this node its ancestor
    cone as a closed ``forward``) but never differentiates — every
    position is a plain forward, so the replay keeps kernel-backed node
    fns (``differentiates = False``) and quantized models need no grad
    twin. All P = gh*gw masked forwards run as one ``lax.scan`` INSIDE
    the staged program: the whole sensitivity sweep is a single XLA
    program on the device, not a host loop of requests. No reference analog
    (its server computed single forwards under ``torch.no_grad``,
    ``/root/reference/main/context.py:79-88``).

    Wiring: input "o" = the scored tensor (typically logits). Outputs:
    "o" = input-shaped importance heatmap (mean score-drop per pixel
    over every window covering it, per-sample min-max normalized so
    bright = occluding hurts most, broadcast to 3 channels — wire into
    ``img_view``/``overlay``); "g" = the raw signed drop grid
    ``[..., gh, gw]`` f32 (extra channel: negative = occluding HELPED).

    Params (stringly, wire contract ``/root/reference/main/graph.py:7-10``):
      target  max | sum | class  scalar per sample from the wired tensor
      class   int                class index for target=class. DYNAMIC.
      patch   int (default 32)   occluder size, pixels (static: sets the
                                 scan geometry)
      stride  int (default = patch)  slide step; < patch overlaps
      fill    float (default 0)  occluder value. DYNAMIC: scrub the
                                 baseline live without a recompile.
      wrt     as saliency        the leaf to occlude — must be
                                 image-shaped ([C,H,W] or [B,C,H,W])
    """

    differentiates = False  # forwards only — replay keeps kernel fns

    def __init__(self) -> None:
        super().__init__("occlusion")

    def contents(self, params):
        target = params.get("target", "max")
        return ("<p>occlusion sensitivity</p>"
                + self._sel_html("target", self.TARGETS, target) + " "
                + _num_input("class", int(float(params.get("class", 0))),
                             step="1", title="class (target=class)")
                + "<br>" + _num_input(
                    "patch", int(float(params.get("patch", 32))),
                    step="1", title="occluder size (px)")
                + " " + _num_input(
                    "stride",
                    int(float(params.get("stride",
                                         params.get("patch", 32)))),
                    step="1", title="slide step (px)")
                + " " + _num_input("fill", float(params.get("fill", 0.0)),
                                   title="occluder fill value")
                + "<br>" + self._wrt_html(params))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "g"]}

    def extra_outs(self, params):
        return ["g"]

    def dynamic_params(self):
        # scrubbing the class index / occluder value is the interaction
        return frozenset({"class", "fill"})

    def captures(self, params):
        return {"class": np.int32(int(float(params.get("class", 0)))),
                "fill": np.float32(float(params.get("fill", 0.0)))}

    def _decode(self, params):
        target = self._check_target(params.get("target", "max"))
        patch = int(float(params.get("patch", 32)))
        stride = int(float(params.get("stride", patch)))
        if patch < 1:
            raise ValueError("patch must be >= 1")
        if stride < 1:
            raise ValueError("stride must be >= 1")
        return target, patch, stride

    def grad_fn(self, params):
        target, patch, stride = self._decode(params)

        def run(forward, x, caps):
            if x.ndim not in (3, 4) or x.shape[-3] not in (1, 3):
                raise ValueError(
                    "occlusion needs an image-shaped wrt leaf [C,H,W] or "
                    f"[B,C,H,W] with 1 or 3 channels; got {x.shape}")
            H, W = int(x.shape[-2]), int(x.shape[-1])
            ph, pw = min(patch, H), min(patch, W)
            # window origins cover the full image: ceil-divide, then the
            # last origin clamps to the edge (duplicate coverage is
            # harmless — the canvas divides by per-pixel window count)
            gh = 1 + -(-(H - ph) // stride)
            gw = 1 + -(-(W - pw) // stride)
            fill = caps["fill"].astype(x.dtype)

            batched = x.ndim == 4
            B = int(x.shape[0]) if batched else None

            def scores(xv):
                """Per-sample scalar: the target reduces the class axis,
                then everything else sums down to one score per LEAF
                sample (the leaf defines the batch — unlike gradients,
                occlusion drops don't decouple per sample on their own,
                so each sample needs its own score)."""
                y = forward(xv).astype(jnp.float32)
                if target == "class":
                    c = jnp.clip(caps["class"], 0, y.shape[-1] - 1)
                    y = jnp.take(y, c, axis=-1)
                elif target == "max":
                    y = jnp.max(y, axis=-1)
                else:
                    y = jnp.sum(y, axis=-1)
                if batched and y.ndim >= 1 and y.shape[0] == B:
                    return jnp.sum(y, axis=tuple(range(1, y.ndim)))
                s = jnp.sum(y)
                # leaf batched but the wired tensor has no matching batch
                # axis (degenerate wiring): every sample shares the score
                return jnp.full((B,), s) if batched else s

            base = scores(x)
            rows = jnp.arange(H)[:, None]
            cols = jnp.arange(W)[None, :]

            def body(carry, p):
                canvas, count = carry
                py = jnp.minimum((p // gw) * stride, H - ph)
                px = jnp.minimum((p % gw) * stride, W - pw)
                m = ((rows >= py) & (rows < py + ph)
                     & (cols >= px) & (cols < px + pw))
                d = base - scores(jnp.where(m, fill, x))
                canvas = canvas + d[..., None, None] * m
                count = count + m.astype(jnp.float32)
                return (canvas, count), d

            (canvas, count), drops = jax.lax.scan(
                body,
                (jnp.zeros(base.shape + (H, W), jnp.float32),
                 jnp.zeros((H, W), jnp.float32)),
                jnp.arange(gh * gw))
            heat = canvas / jnp.maximum(count, 1.0)
            # min-max render (per sample): bright = occluding hurts most
            # (strongest supporting evidence). NOT relu/max: on a map
            # whose drops are all negative (occlusion HELPED everywhere —
            # routine on untrained or adversarial inputs) relu renders
            # solid black, hiding the structure that is still there.
            hw_axes = tuple(range(base.ndim, heat.ndim))
            lo = jnp.min(heat, axis=hw_axes, keepdims=True)
            hi = jnp.max(heat, axis=hw_axes, keepdims=True)
            heat = (heat - lo) / jnp.maximum(hi - lo, 1e-12)
            heat = jnp.broadcast_to(
                heat[..., None, :, :], base.shape + (3, H, W))
            g = jnp.moveaxis(drops, 0, -1).reshape(base.shape + (gh, gw))
            return {"o": heat.astype(x.dtype), "g": g}

        return run

    def fn(self, params):
        self._decode(params)  # surface param errors with node attribution
        raise NotImplementedError(
            "occlusion re-evaluates the WHOLE upstream graph per mask "
            "position — staged executor only")

    def compute(self, params, inputs):
        self.fn(params)


class ImgViewNode(NodeKind):
    """Viewer sink: echoes whatever channels are wired (R,G,B 2-D or o CHW).

    Client contract: ``img_view_node.js:76-80`` (R/G/B each 2-D, or 'o' with
    C==3). Server-side we tap-through so the frontend can read the composed
    inputs from the response.
    """

    def __init__(self) -> None:
        super().__init__("img_view")

    def io(self, params):
        return {"ins": ["R", "G", "B", "o"], "outs": []}

    def fn(self, params):
        return lambda ins: {}

    # viewers accept any subset of inputs; skip the missing-input check by
    # declaring only the wired channels at validation time via io() — the
    # executor treats viewers specially (optional inputs).
    optional_inputs = True


def instances():
    """Plugin-contract entry point (``context.py:170-171``) — THE single
    list of built-in kinds; ``register_builtin`` iterates it so the two
    registration paths cannot diverge."""
    return [
        CosNode(),
        BinOpNode(),
        SliceNode(),
        ShuffleNode(),
        ConstNode(),
        NoiseNode(),
        Conv2dNode(),
        ResizeNode(),
        PcaViewNode(),
        PatchSimNode(),
        SimilarityNode(),
        SaliencyNode(),
        DreamNode(),
        OcclusionNode(),
        IdentityNode("img_src", ["o"], ["o"]),
        ImgViewNode(),
        IdentityNode("multi_view", ["o"], []),
        IdentityNode("category", ["o"], []),
        # client-rendered viewer sinks (frontend/js/nodes.js AttnViewNode /
        # OverlayNode): identity pass-throughs so saved graphs containing
        # them evaluate fully server-side and the taps ship to the client
        IdentityNode("attn_view", ["attn", "r"], [], optional=True),
        IdentityNode("overlay", ["o", "r"], [], optional=True),
    ]


def register_builtin(reg: Registry) -> None:
    """Register all built-in node kinds."""
    for kind in instances():
        kind.register(reg)
