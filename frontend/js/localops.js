// Client-local evaluation of cheap tensor ops — the zero-round-trip path.
//
// The reference computed EVERY non-model node client-side on WebGPU
// (gpu.js:144-283 strided views + WGSL kernels), so re-slicing an image
// the client already holds cost zero network. This framework evaluates
// server-side by default (docs/parity_map.md §2.2), which put a network
// round trip on every viewer-local edit. This module restores the
// reference's capability for the O(pixels) ops: when a node's whole
// ancestry is client-held (img_src tensors + these ops) and nothing
// downstream needs the server, graph.js evaluates it HERE and skips the
// round trip entirely.
//
// Semantics mirror the server ops (interactive_vit_tpu/ops/node_ops.py) —
// the per-kind contract fixtures (tests/fixtures/node_fixtures.json) pin
// both sides to the same expected values; wire.test.mjs replays them
// against this module when a JS runtime exists.
//
// Tensor convention: {dims: number[], data: Float32Array} (wire.js).

/** Kinds this module can evaluate client-side. (noise is EXCLUDED on
 * purpose: the server's jax.random stream cannot be replicated here, and
 * value-stability across eval paths is part of its contract.) */
export const LOCAL_KINDS = new Set([
	"cos", "binop", "slice", "shuffle", "const", "conv2d", "resize",
]);

/** Thrown when an input combination needs the server (e.g. a broadcast
 * binop) — graph.js demotes the node to server eval for that pass. */
export class LocalFallback extends Error {}

function numel(dims) {
	let n = 1;
	for (const d of dims) n *= d;
	return n;
}

function cosOp(inst, x) {
	const a = Number(inst.A ?? 1);
	const b = Number(inst.b ?? 0);
	const out = new Float32Array(x.data.length);
	for (let i = 0; i < x.data.length; i++) out[i] = Math.cos(a * x.data[i] + b);
	return { dims: [...x.dims], data: out };
}

function binOp(inst, a, b) {
	const op = inst.op ?? "+";
	const fns = {
		"+": (x, y) => x + y,
		"-": (x, y) => x - y,
		"*": (x, y) => x * y,
		"/": (x, y) => x / y,
	};
	const f = fns[op];
	if (!f) throw new LocalFallback(`unknown op ${op}`);
	const sameDims =
		a.dims.length === b.dims.length && a.dims.every((d, i) => d === b.dims[i]);
	// equal shapes or a 1-element operand; anything fancier (NumPy
	// broadcasting) goes to the server
	if (sameDims) {
		const out = new Float32Array(a.data.length);
		for (let i = 0; i < out.length; i++) out[i] = f(a.data[i], b.data[i]);
		return { dims: [...a.dims], data: out };
	}
	if (numel(b.dims) === 1) {
		const s = b.data[0];
		const out = new Float32Array(a.data.length);
		for (let i = 0; i < out.length; i++) out[i] = f(a.data[i], s);
		return { dims: [...a.dims], data: out };
	}
	if (numel(a.dims) === 1) {
		const s = a.data[0];
		const out = new Float32Array(b.data.length);
		for (let i = 0; i < out.length; i++) out[i] = f(s, b.data[i]);
		return { dims: [...b.dims], data: out };
	}
	throw new LocalFallback("broadcast binop needs the server");
}

/** slice/shuffle shared logic (node_ops._IndexNode): fixed {dim,val}
 * pins input dims; free {in_dim,out_dim} reorders the survivors. */
function indexOp(inst, x) {
	const fixed = inst.fixed ?? [];
	const free = inst.free ?? [];
	const nd = x.dims.length;
	if (fixed.length + free.length !== nd) {
		throw new LocalFallback(
			`index spec covers ${fixed.length + free.length} dims, input has ${nd}`,
		);
	}
	const strides = new Array(nd);
	let s = 1;
	for (let i = nd - 1; i >= 0; i--) {
		strides[i] = s;
		s *= x.dims[i];
	}
	let base = 0;
	for (const f of fixed) {
		const v = Number(f.val) | 0;
		const d = Number(f.dim) | 0;
		if (v < 0 || v >= x.dims[d]) {
			throw new LocalFallback(`fixed index ${v} out of range for dim ${d}`);
		}
		base += v * strides[d];
	}
	const outDims = new Array(free.length);
	const inStride = new Array(free.length);
	for (const f of free) {
		outDims[f.out_dim] = x.dims[f.in_dim];
		inStride[f.out_dim] = strides[f.in_dim];
	}
	const out = new Float32Array(numel(outDims));
	const idx = new Array(free.length).fill(0);
	for (let o = 0; o < out.length; o++) {
		let off = base;
		for (let d = 0; d < idx.length; d++) off += idx[d] * inStride[d];
		out[o] = x.data[off];
		for (let d = idx.length - 1; d >= 0; d--) {
			if (++idx[d] < outDims[d]) break;
			idx[d] = 0;
		}
	}
	return { dims: outDims, data: out };
}

function constOp(inst) {
	const dims = (inst.dims ?? [1]).map((d) => Number(d) | 0);
	const out = new Float32Array(numel(dims));
	out.fill(Number(inst.value ?? 0));
	return { dims, data: out };
}

/** Valid-padding single-kernel conv over [H,W] or [C,H,W] (node_ops
 * Conv2dNode: channels share one k×k matrix, spatial dims shrink). */
function conv2dOp(inst, x) {
	const h = Number(inst.h ?? 3) | 0;
	const w = Number(inst.w ?? 3) | 0;
	let m;
	if (inst.matrix) {
		try {
			// bad base64 / non-multiple-of-4 byte length throw here; the
			// server path returns the attributed per-node error instead
			const raw = atob(inst.matrix);
			const bytes = new Uint8Array(raw.length);
			for (let i = 0; i < raw.length; i++) bytes[i] = raw.charCodeAt(i);
			m = new Float32Array(bytes.buffer);
		} catch (e) {
			throw new LocalFallback(`bad conv matrix encoding: ${e}`);
		}
		if (m.length !== h * w) {
			throw new LocalFallback(`matrix has ${m.length} cells, spec ${h}x${w}`);
		}
	} else {
		m = new Float32Array(h * w);
		m[Math.floor((h * w) / 2)] = 1;
	}
	const squeeze = x.dims.length === 2;
	const [c, ih, iw] = squeeze ? [1, ...x.dims] : x.dims;
	if (x.dims.length !== 2 && x.dims.length !== 3) {
		throw new LocalFallback(`conv2d expects [H,W] or [C,H,W], got rank ${x.dims.length}`);
	}
	const oh = ih - h + 1;
	const ow = iw - w + 1;
	if (oh <= 0 || ow <= 0) throw new LocalFallback("kernel larger than input");
	const out = new Float32Array(c * oh * ow);
	for (let ci = 0; ci < c; ci++) {
		const inOff = ci * ih * iw;
		const outOff = ci * oh * ow;
		for (let i = 0; i < oh; i++) {
			for (let j = 0; j < ow; j++) {
				let acc = 0;
				for (let ki = 0; ki < h; ki++) {
					for (let kj = 0; kj < w; kj++) {
						acc += m[ki * w + kj] * x.data[inOff + (i + ki) * iw + (j + kj)];
					}
				}
				out[outOff + i * ow + j] = acc;
			}
		}
	}
	return { dims: squeeze ? [oh, ow] : [c, oh, ow], data: out };
}

/** Antialiased-bilinear resampling matrix [outSize, inSize] — the same
 * construction as ops/preprocess_mm.resize_matrix (half-pixel centers,
 * triangle kernel dilated by the scale when downsampling, rows
 * renormalized), which is parity-locked to jax.image.resize — the server
 * resize node's engine. */
export function resizeMatrix(inSize, outSize) {
	const scale = inSize / outSize;
	const support = Math.max(1, scale);
	const w = new Float32Array(outSize * inSize);
	for (let i = 0; i < outSize; i++) {
		const center = (i + 0.5) * scale - 0.5;
		const lo = Math.max(0, Math.floor(center - support));
		const hi = Math.min(inSize - 1, Math.ceil(center + support));
		let sum = 0;
		for (let j = lo; j <= hi; j++) {
			const t = Math.abs(j - center) / support;
			if (t < 1) {
				w[i * inSize + j] = 1 - t;
				sum += 1 - t;
			}
		}
		if (sum > 0) for (let j = lo; j <= hi; j++) w[i * inSize + j] /= sum;
	}
	return w;
}

/** Bilinear resize of the trailing two dims to dims=[H,W]. */
function resizeOp(inst, x) {
	const [nh, nw] = (inst.dims ?? [224, 224]).map((d) => Number(d) | 0);
	if (x.dims.length < 2) throw new LocalFallback("resize needs rank >= 2");
	const ih = x.dims[x.dims.length - 2];
	const iw = x.dims[x.dims.length - 1];
	const lead = numel(x.dims.slice(0, -2));
	const rh = resizeMatrix(ih, nh);
	const rw = resizeMatrix(iw, nw);
	const out = new Float32Array(lead * nh * nw);
	const tmp = new Float32Array(nh * iw);
	for (let b = 0; b < lead; b++) {
		const inOff = b * ih * iw;
		// rows: tmp[s, w] = sum_h rh[s,h] x[h,w]
		tmp.fill(0);
		for (let s0 = 0; s0 < nh; s0++) {
			for (let h0 = 0; h0 < ih; h0++) {
				const c = rh[s0 * ih + h0];
				if (c === 0) continue;
				for (let w0 = 0; w0 < iw; w0++) {
					tmp[s0 * iw + w0] += c * x.data[inOff + h0 * iw + w0];
				}
			}
		}
		// cols: out[s, t] = sum_w tmp[s,w] rw[t,w]
		const outOff = b * nh * nw;
		for (let s0 = 0; s0 < nh; s0++) {
			for (let t0 = 0; t0 < nw; t0++) {
				let acc = 0;
				for (let w0 = 0; w0 < iw; w0++) {
					acc += tmp[s0 * iw + w0] * rw[t0 * iw + w0];
				}
				out[outOff + s0 * nw + t0] = acc;
			}
		}
	}
	return { dims: [...x.dims.slice(0, -2), nh, nw], data: out };
}

/**
 * Evaluate one node locally.
 * @param {string} kind node kind (must be in LOCAL_KINDS)
 * @param {object} inst the node's serialized instance fields
 * @param {(ch: string) => ({dims,data}|null)} read input reader
 * @returns {Map<string, {dims,data}>} channel -> tensor
 * @throws {LocalFallback} when this combination needs the server
 */
export function evalLocal(kind, inst, read) {
	const need = (ch) => {
		const t = read(ch);
		if (!t) throw new LocalFallback(`missing input ${ch}`);
		return t;
	};
	switch (kind) {
		case "cos":
			return new Map([["o", cosOp(inst, need("o"))]]);
		case "binop":
			return new Map([["c", binOp(inst, need("a"), need("b"))]]);
		case "slice":
		case "shuffle":
			return new Map([["o", indexOp(inst, need("o"))]]);
		case "const":
			return new Map([["o", constOp(inst)]]);
		case "conv2d":
			return new Map([["o", conv2dOp(inst, need("o"))]]);
		case "resize":
			return new Map([["o", resizeOp(inst, need("o"))]]);
		default:
			throw new LocalFallback(`no local impl for ${kind}`);
	}
}
