"""Weight-only int8 quantization for the serving path.

Interactive serving runs at small effective batch (1-8 concurrent graph
evals), where a step is dominated by streaming weights from device
memory, not by matmul flops. Storing linear-layer weights as symmetric
per-output-channel int8 halves that traffic; activations stay bf16 and the scale is applied
AFTER the matmul (``(x @ q) * s == x @ (q * s)`` for a per-column scale),
so the dequantized weight matrix is never materialized — XLA fuses the
s8->bf16 convert into the matmul's weight read.

The reference has no quantization (CPU f32 torch end-to-end,
the reference's ``main/context.py:79-88``); this is a serving
extension. Accuracy caveat: per-channel weight-only int8 on ViTs is
empirically near-lossless, but this image has no pretrained weights or
eval data (zero egress), so the shipped guarantee is the *numerical*
bound tested in ``tests/test_quant.py`` (quantization error only, no
compounding surprises), not a top-1 delta. Validate on real checkpoints
before production use.
"""

from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

#: key markers for a quantized-weight leaf-dict
QKEY, SKEY = "int8_q", "int8_s"
#: key markers for a W8A8 leaf-dict: same int8 weight + per-column scale,
#: but under DIFFERENT keys so the mode is *structural* — pytree key
#: presence is static under jit (params ride as jit arguments on the bench
#: path, so a string/flag leaf would fail tracing). With W8A8 the matmul
#: itself runs int8 x int8 -> int32 (XLA's integer dot); activations are
#: dynamically per-token quantized at trace time.
AQKEY, ASKEY = "int8a8_q", "int8a8_s"


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and QKEY in w


def is_w8a8(w: Any) -> bool:
    return isinstance(w, dict) and AQKEY in w


def quantize_weight(w, mode: str = "w8") -> Dict[str, jnp.ndarray]:
    """[D_in, D_out] float -> symmetric per-output-channel int8 + f32 scale.

    scale[j] = max_i |w[i, j]| / 127; q = round(w / scale), so
    |w - q * scale| <= scale/2 elementwise. ``mode="w8a8"`` stores the
    same data under the W8A8 keys (structural mode marker — see AQKEY).
    """
    wf = np.asarray(w, np.float32)
    assert wf.ndim == 2, f"quantize_weight wants 2-D, got {wf.shape}"
    s = np.max(np.abs(wf), axis=0) / 127.0
    s = np.where(s == 0, 1.0, s)
    q = np.clip(np.round(wf / s), -127, 127).astype(np.int8)
    qk, sk = (QKEY, SKEY) if mode == "w8" else (AQKEY, ASKEY)
    return {qk: jnp.asarray(q), sk: jnp.asarray(s, jnp.float32)}


def dequantize_weight(w: Dict[str, jnp.ndarray], dtype=jnp.float32):
    q = w[QKEY] if QKEY in w else w[AQKEY]
    s = w[SKEY] if SKEY in w else w[ASKEY]
    return (q.astype(jnp.float32) * s).astype(dtype)


def quantize_acts(x: jnp.ndarray):
    """Dynamic symmetric per-token int8 quantization of activations.

    x [..., D] -> (q int8 [..., D], s f32 [..., 1]) with
    q = round(x / s), s = max_d |x[..., d]| / 127. Runs inside jit: the
    abs-max reduce + scale + round + clip chain fuses into the producing
    fusion (one extra elementwise pass over the activations).
    """
    xf = x.astype(jnp.float32)
    s = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
    s = jnp.where(s == 0, 1.0, s)
    q = jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8)
    return q, s


def linear_w8a8(x: jnp.ndarray, w: Dict[str, jnp.ndarray], b=None):
    """x @ W + b with BOTH operands int8: an s8 x s8 -> s32 dot in XLA.
    Dequantization is a rank-1 rescale of the int32 accumulator:
    y = acc * (s_x[..., None] * s_w[None, :]).

    Accuracy class: dynamic per-token activation + per-output-channel
    weight symmetric int8 (the standard W8A8 recipe). Unlike weight-only
    int8 this perturbs activations too; it is strictly opt-in and excluded
    from the parity/headline paths. See tests/test_quant.py for the
    numeric bound on a full ViT forward.
    """
    qx, sx = quantize_acts(x)
    acc = jnp.dot(qx, w[AQKEY], preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (sx * w[ASKEY])
    if b is not None:
        y = y + b
    return y.astype(x.dtype)


#: transformer-block linear weights: the standard weight-only targets.
#: First (patch embed) and last (classifier head) layers stay dense — the
#: usual int8 recipe exclusion: their error lands directly on the patch
#: features / logits, and they are a negligible share of HBM traffic.
BLOCK_WEIGHTS = frozenset({"qkv_w", "proj_w", "fc1_w", "fc2_w"})


def quantize_tree(params: Any, names: frozenset = BLOCK_WEIGHTS,
                  mode: str = "w8") -> Any:
    """Replace 2-D float weight leaves named in ``names`` with their int8
    form; everything else (norms, biases, embeddings, first/last-layer
    weights) is untouched. ``mode``: "w8" (weight-only) or "w8a8"
    (int8 activations too — opt-in accuracy class)."""

    def walk(obj: Any) -> Any:
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if (
                    k in names
                    and hasattr(v, "ndim")
                    and v.ndim == 2
                    and jnp.issubdtype(v.dtype, jnp.floating)
                ):
                    out[k] = quantize_weight(v, mode=mode)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        if isinstance(obj, tuple):
            return tuple(walk(v) for v in obj)
        return obj

    return walk(params)
