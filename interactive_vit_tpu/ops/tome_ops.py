"""Token merging (ToMe) — static-shape bipartite soft matching.

Inference-time acceleration (Bolya et al. 2023, "Token Merging: Your ViT
But Faster"): between a block's attention and MLP, the ``r`` most similar
token PAIRS merge into size-weighted averages, so every later layer runs
on fewer tokens. A capability class the reference could not express (its
server evaluates fixed torch modules under ``torch.no_grad`` on CPU,
``/root/reference/main/context.py:79-88`` — no model surgery, no token
reduction anywhere).

The static shape of the algorithm — and why it fits a compiled backend:

* **Static shapes end-to-end.** ``r`` is a trace-time constant, so block
  ``i`` always maps ``[B, N_i, D] -> [B, N_i - r, D]``: XLA sees a fixed
  shape ladder, every matmul keeps a static shape, nothing recompiles at
  serve time.
* **Matching is one matmul + one sort.** The bipartite scores are a
  single ``[Na, Dk] x [Dk, Nb]`` dot and partner selection is an
  ``argsort`` over ``Na`` scalars — no data-dependent control flow.
* **Merging is a one-hot matmul, not a scatter.** ``apply_merge``
  materializes the lut as a one-hot assignment matrix and folds rows
  with an einsum — a ``[n_new, N] x [N, D]`` contraction (~2% extra
  model FLOPs), where the scatter-add formulation lowered to serialized
  dense-update loops on the backend this was first built for. Same
  rewrite that fixed the MoE dispatch (docs/kernels.md "MoE dispatch"); the scatter survives only
  in the numpy reference.

Semantics (pinned against ``bipartite_merge_reference``, a per-sample
numpy transliteration of the published construction):

* tokens alternate into sets **a** (even indices) and **b** (odd);
* each a-token's best partner in b is scored by cosine similarity of
  the attention KEYS (head-meaned) — the published metric;
* the ``r`` highest-scoring a-tokens merge into their partners as
  size-weighted averages (sizes accumulate, so a token that already
  absorbed 3 originals weighs 4x in its next merge);
* the CLS token (index 0, in set a) is protected: its score is -inf;
* attention downstream is corrected by **proportional attention**
  (``softmax(q k^T / sqrt(dh) + log s)``) — implemented as
  ``attention_reference(key_bias=...)``.

Order note: survivors keep a deterministic layout ``[kept-a (ascending,
CLS first) | all-b]``; attention is permutation-equivariant past the
(already-added) position embeddings, so token order is a layout choice,
not semantics.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from interactive_vit_tpu.ops.layers import mm_precision


def merge_counts(n: int, r: int, protect: int = 1) -> int:
    """The effective merge count at sequence length ``n``: ``r`` clamped
    so protected tokens survive and at most every a-token merges."""
    na = (n + 1) // 2
    return max(0, min(r, na - protect))


def bipartite_matching(
    metric: jnp.ndarray, r: int, protect: int = 1
) -> Tuple[jnp.ndarray, int]:
    """Pick the ``r`` most-similar (a, b) token pairs to merge.

    Args:
      metric: [B, N, Dk] similarity metric (head-meaned attention keys).
      r:      pairs to merge (trace-time constant; pre-clamped via
              ``merge_counts``).
      protect: leading tokens that never merge (CLS).

    Returns ``(lut [B, N] int32, n_new)``: ``lut`` maps every OLD token
    index to its NEW index (merged a-tokens map to their absorber's new
    index), with survivors laid out ``[kept-a ascending | all-b]``.
    """
    b, n, _ = metric.shape
    r = merge_counts(n, r, protect)
    if r == 0:
        return (jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (b, n)),
                n)
    na, nb = (n + 1) // 2, n // 2

    mf = metric.astype(jnp.float32)
    mf = mf / jnp.maximum(
        jnp.linalg.norm(mf, axis=-1, keepdims=True), 1e-6)
    ma, mb = mf[:, 0::2], mf[:, 1::2]
    scores = jnp.einsum("bad,bcd->bac", ma, mb,
                        precision=mm_precision(ma, mb))  # [B, Na, Nb]
    if protect:
        scores = scores.at[:, :protect, :].set(-jnp.inf)
    node_max = jnp.max(scores, axis=-1)                   # [B, Na]
    node_idx = jnp.argmax(scores, axis=-1)                # [B, Na]

    # one argsort yields a disjoint merged/kept partition (two top_k calls
    # could overlap under score ties)
    order = jnp.argsort(-node_max, axis=-1)               # [B, Na]
    merge_rows = order[:, :r]                             # a-idx, merged
    keep_rows = jnp.sort(order[:, r:], axis=-1)           # a-idx, kept
    # ascending keep order leaves protected tokens (lowest indices,
    # -inf scores => always kept) at the front: CLS stays token 0
    dst = jnp.take_along_axis(node_idx, merge_rows, axis=1)  # [B, r] b-idx

    bix = jnp.arange(b)[:, None]
    n_keep = na - r
    lut = jnp.zeros((b, n), jnp.int32)
    lut = lut.at[bix, 2 * keep_rows].set(
        jnp.broadcast_to(jnp.arange(n_keep, dtype=jnp.int32), (b, n_keep)))
    lut = lut.at[bix, 2 * jnp.arange(nb)[None, :] + 1].set(
        jnp.broadcast_to(
            n_keep + jnp.arange(nb, dtype=jnp.int32), (b, nb)))
    lut = lut.at[bix, 2 * merge_rows].set(
        (n_keep + dst).astype(jnp.int32))
    return lut, n - r


def apply_merge(
    values: jnp.ndarray, s: jnp.ndarray, lut: jnp.ndarray, n_new: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge rows of ``values`` [B, N, ...] per ``lut``, size-weighted.

    ``out[b, j] = Σ_{i: lut[b,i]=j} s[b,i]·values[b,i] / Σ s[b,i]`` —
    one size-weighted row fold shared by the token stream, the rollout
    carry, and anything else that must merge consistently with the
    tokens. Returns ``(merged [B, n_new, ...], s_new [B, n_new])``.

    The fold is an einsum against the one-hot assignment matrix, not a
    scatter-add: batched scatters lowered to serialized update loops on
    the backend this was first built for (the same fix as the MoE
    dispatch einsums).
    """
    b, n = values.shape[:2]
    sf = s.astype(jnp.float32)
    # [B, N, n_new] one-hot: onehot[b, i, lut[b, i]] = 1
    onehot = (lut[:, :, None]
              == jnp.arange(n_new, dtype=lut.dtype)).astype(jnp.float32)
    s_new = jnp.einsum("bnj,bn->bj", onehot, sf,
                       precision=mm_precision(onehot, sf))
    # value fold in the values' compute class: bf16 inputs run at
    # DEFAULT (f32 accumulation; 0/1 one-hot entries are exact in bf16),
    # f32 inputs get HIGHEST.
    cdt = values.dtype if values.dtype == jnp.bfloat16 else jnp.float32
    flat = (values.reshape(b, n, -1).astype(jnp.float32)
            * sf[:, :, None]).astype(cdt)
    oh_c = onehot.astype(cdt)
    acc = jnp.einsum("bnj,bnk->bjk", oh_c, flat,
                     precision=mm_precision(oh_c, flat)
                     ).astype(jnp.float32)
    out = acc / s_new[:, :, None]
    out = out.reshape((b, n_new) + values.shape[2:])
    return out.astype(values.dtype), s_new


def bipartite_merge(
    x: jnp.ndarray,
    s: jnp.ndarray,
    metric: jnp.ndarray,
    r: int,
    protect: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Matching + merge in one call: ``[B,N,D] -> [B,N-r,D]``.

    Returns ``(x_out, s_out [B,N-r] f32, lut [B,N] int32)``.
    """
    lut, n_new = bipartite_matching(metric, r, protect)
    if n_new == x.shape[1]:
        return x, s.astype(jnp.float32), lut
    x_out, s_out = apply_merge(x, s, lut, n_new)
    return x_out, s_out, lut


def bipartite_merge_reference(x, s, metric, r: int, protect: int = 1):
    """Semantic ground truth: per-sample numpy loop (tests only)."""
    x = np.asarray(x, np.float64)
    s = np.asarray(s, np.float64)
    metric = np.asarray(metric, np.float64)
    b, n, d = x.shape
    r = merge_counts(n, r, protect)
    if r == 0:
        return x, s, np.broadcast_to(np.arange(n, dtype=np.int32), (b, n))
    na, nb = (n + 1) // 2, n // 2
    xs, ss, luts = [], [], []
    for i in range(b):
        m = metric[i] / np.maximum(
            np.linalg.norm(metric[i], axis=-1, keepdims=True), 1e-6)
        scores = m[0::2] @ m[1::2].T                    # [Na, Nb]
        scores[:protect] = -np.inf
        node_max = scores.max(-1)
        node_idx = scores.argmax(-1)
        order = np.argsort(-node_max, kind="stable")
        merge_rows = order[:r]
        keep_rows = np.sort(order[r:])
        xa, xb = x[i, 0::2].copy(), x[i, 1::2].copy()
        sa, sb = s[i, 0::2].copy(), s[i, 1::2].copy()
        acc = xb * sb[:, None]
        for a_row in merge_rows:
            d_row = node_idx[a_row]
            acc[d_row] += xa[a_row] * sa[a_row]
            sb[d_row] += sa[a_row]
        xb = acc / sb[:, None]
        lut = np.zeros(n, np.int32)
        lut[2 * keep_rows] = np.arange(na - r)
        lut[2 * np.arange(nb) + 1] = na - r + np.arange(nb)
        lut[2 * merge_rows] = na - r + node_idx[merge_rows]
        xs.append(np.concatenate([xa[keep_rows], xb]))
        ss.append(np.concatenate([sa[keep_rows], sb]))
        luts.append(lut)
    return np.stack(xs), np.stack(ss), np.stack(luts)


def merge_map_render(assign: jnp.ndarray, skip: int = 1) -> jnp.ndarray:
    """Render a patch->token assignment as a color image [B,3,g,g].

    ``assign`` [B, P] int32: current token index of each ORIGINAL token
    (``skip`` leading CLS entries dropped; the rest must tile a square
    patch grid). Tokens get visually-distinct stable colors via the
    golden-ratio hue walk, so patches sharing a color were merged into
    the same surviving token.
    """
    pa = assign[:, skip:]
    b, p = pa.shape
    g = int(round(float(np.sqrt(p))))
    if g * g != p:
        raise ValueError(
            f"assignment length {p} (skip={skip}) is not a square patch "
            f"grid")
    hue = (pa.astype(jnp.float32) * 0.61803398875) % 1.0
    # HSV -> RGB at s=0.78, v=1.0 (branchless: all three channels are
    # offset triangle waves of the hue)
    h6 = hue * 6.0
    k = jnp.stack([(h6 + 5.0) % 6.0, (h6 + 3.0) % 6.0, (h6 + 1.0) % 6.0])
    rgb = 1.0 - 0.78 * jnp.clip(
        jnp.minimum(jnp.minimum(k, 4.0 - k), 1.0), 0.0, 1.0)
    return rgb.transpose(1, 0, 2).reshape(b, 3, g, g)
