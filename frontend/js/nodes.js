// Node kind implementations: sources, viewers, op nodes, server-layer nodes.
//
// Functional parity with the reference node set
// (/root/reference/main/static/main/nodes/*.js) minus the WGSL compute —
// ops evaluate server-side; this file is param UIs + rendering.
// New beyond the reference: attn_view (per-head attention-map heatmaps, the
// ViT tap visualizer).

import { Context, Node } from "./graph.js";
import {
	attnMaps,
	channelsRGBA,
	headGridCols,
	headMap,
	overlayRGBA,
	queryRowGrid,
	tensorRGBA,
} from "./render.js";

// ---- rendering helpers ---------------------------------------------------------
// The tap->pixels math lives in render.js (pure, fixture-pinned against
// the Python transliteration wire/render.py); this file owns only the
// canvas/DOM plumbing around it.

/** Render CHW [3,H,W] / [1,H,W] / [H,W] tensor into a canvas. */
function drawTensor(canvas, t, maxSize = 224) {
	const r = tensorRGBA(t);
	if (!r) return false;
	canvas.width = r.w;
	canvas.height = r.h;
	const scale = Math.min(1, maxSize / Math.max(r.h, r.w));
	canvas.style.width = `${Math.round(r.w * scale)}px`;
	canvas.style.height = `${Math.round(r.h * scale)}px`;
	canvas.getContext("2d").putImageData(new ImageData(r.rgba, r.w, r.h), 0, 0);
	return true;
}

function labeledInput(label, value, onChange, size = 8) {
	const wrap = document.createElement("label");
	wrap.className = "inline-input";
	wrap.textContent = label;
	const input = document.createElement("input");
	input.value = value;
	input.size = size;
	input.addEventListener("change", () => onChange(input.value));
	wrap.append(input);
	return { wrap, input };
}

// ---- sources ----------------------------------------------------------------------

export class ImgSourceNode extends Node {
	constructor() {
		super("img_src", "image");
		this.addOutput("o");
		this.tensor = null;
	}

	buildContent(el) {
		const input = document.createElement("input");
		input.type = "file";
		input.accept = "image/*";
		const canvas = document.createElement("canvas");
		canvas.className = "preview";
		input.addEventListener("change", async () => {
			const file = input.files[0];
			if (!file) return;
			const bmp = await createImageBitmap(file);
			canvas.width = bmp.width;
			canvas.height = bmp.height;
			canvas.style.maxWidth = "160px";
			const ctx = canvas.getContext("2d");
			ctx.drawImage(bmp, 0, 0);
			const { data, width, height } = ctx.getImageData(0, 0, bmp.width, bmp.height);
			// RGBA u8 -> CHW f32 / 255 (reference img_source_node.js:6-26)
			const plane = width * height;
			const out = new Float32Array(3 * plane);
			for (let i = 0; i < plane; i++) {
				out[i] = data[4 * i] / 255;
				out[plane + i] = data[4 * i + 1] / 255;
				out[2 * plane + i] = data[4 * i + 2] / 255;
			}
			this.tensor = { dims: [3, height, width], data: out };
			Context.changed();
		});
		el.append(input, canvas);
	}

	isSource() {
		return true;
	}

	sourceTensor() {
		return this.tensor;
	}

	serializeExtra() {
		return {}; // image pixels are not saved (reference contract)
	}
}

// ---- viewers ----------------------------------------------------------------------

export class ImgViewNode extends Node {
	constructor() {
		super("img_view", "view");
		for (const ch of ["R", "G", "B", "o"]) this.addInput(ch);
		this.canvas = null;
	}

	buildContent(el) {
		this.canvas = document.createElement("canvas");
		el.append(this.canvas);
	}

	isViewer() {
		return true;
	}

	onInputs(read) {
		const o = read("o");
		if (o && (o.dims.length === 3 || o.dims.length === 2)) {
			drawTensor(this.canvas, o);
			return;
		}
		// channel compositing path (img_view_node.js:76-133)
		const res = channelsRGBA(["R", "G", "B"].map((c) => read(c)));
		if (!res) return;
		this.canvas.width = res.w;
		this.canvas.height = res.h;
		this.canvas.style.maxWidth = "224px";
		this.canvas
			.getContext("2d")
			.putImageData(new ImageData(res.rgba, res.w, res.h), 0, 0);
	}
}

export class MultiViewNode extends Node {
	constructor() {
		super("multi_view", "channels");
		this.addInput("o");
	}

	buildContent(el) {
		this.grid = document.createElement("div");
		this.grid.className = "multiview-grid";
		el.append(this.grid);
	}

	isViewer() {
		return true;
	}

	onInputs(read) {
		const t = read("o");
		if (!t) return; // transient failed eval: keep the last render
		this.grid.textContent = "";
		let c;
		let h;
		let w;
		if (t.dims.length === 3) [c, h, w] = t.dims;
		else if (t.dims.length === 4 && t.dims[0] === 1) [, c, h, w] = t.dims;
		else return;
		const cols = Math.ceil(Math.sqrt(c));
		this.grid.style.gridTemplateColumns = `repeat(${cols}, 1fr)`;
		const show = Math.min(c, 64);
		for (let ci = 0; ci < show; ci++) {
			const canvas = document.createElement("canvas");
			canvas.title = `channel ${ci}`;
			drawTensor(
				canvas,
				{
					dims: [h, w],
					data: t.data.subarray(ci * h * w, (ci + 1) * h * w),
				},
				Math.max(28, 224 / cols),
			);
			this.grid.append(canvas);
		}
	}
}

export class CategoryNode extends Node {
	constructor(cats) {
		super("category", "categories");
		this.addInput("o");
		this.cats = cats || [];
	}

	buildContent(el) {
		this.list = document.createElement("div");
		this.list.className = "category-list";
		el.append(this.list);
	}

	isViewer() {
		return true;
	}

	serializeExtra() {
		return { cats: this.cats };
	}

	onInputs(read) {
		const t = read("o");
		if (!t) return; // transient failed eval: keep the last render
		this.list.textContent = "";
		// [C] or [B,C]: rank over ONE batch element's class axis — flat
		// ranking over a [B>1,C] buffer would mix batch elements and
		// produce out-of-range class indices
		let logits = t.data;
		if (t.dims.length === 2) {
			logits = t.data.subarray(0, t.dims[1]);
		} else if (t.dims.length !== 1) {
			return;
		}
		const idx = [...logits.keys()].sort((a, b) => logits[b] - logits[a]);
		const mx = logits[idx[0]];
		const mn = logits[idx[idx.length - 1]];
		for (const i of idx.slice(0, 8)) {
			const row = document.createElement("div");
			row.className = "category-row";
			const frac = (logits[i] - mn) / (mx - mn || 1);
			row.style.background = `linear-gradient(90deg, #2a6 ${frac * 100}%, transparent ${frac * 100}%)`;
			row.textContent = `${this.cats[i] ?? `#${i}`}: ${logits[i].toFixed(3)}`;
			this.list.append(row);
		}
	}
}

export class AttnViewNode extends Node {
	constructor(inst) {
		super("attn_view", "attention");
		this.addInput("attn");
		this.addInput("r"); // accepts a rollout map [B,N,N] too
		this.head = inst?.head ?? 0;
		this.query = inst?.query ?? 0; // 0 = CLS
		// selective mode: push attn_heads=[head] onto the upstream block
		// node so ONLY the viewed head's map ships (and is stored) —
		// at ViT-L/16@384 that's 8 GB -> 0.5 GB of tap memory
		this.selective = inst?.selective ?? false;
		this.numHeads = inst?.numHeads ?? 0;
	}

	serializeExtra() {
		// numHeads persists so a RELOADED selective viewer can still
		// clamp (it can't re-learn the true head count while only one
		// head ships)
		return { head: this.head, query: this.query,
			selective: this.selective, numHeads: this.numHeads };
	}

	/** Write the selective-head param onto the upstream net_node feeding
	 * our "attn" input and re-evaluate (the param is static: the server
	 * recompiles once per head set, then scrubbing stays cached).
	 *
	 * Called from USER GESTURES ONLY (checkbox, head edit while
	 * selective) and from onRemoved — never from onInputs: an every-eval
	 * sync made two viewers of one block fight over the param in an
	 * endless eval loop, and a non-selective viewer clobbered values the
	 * user typed into the block's own "tap heads" field. This viewer
	 * only ever deletes a param IT set (``_syncTarget`` ownership). */
	syncUpstream(clearOnly = false) {
		const e = Context.edges.find(
			(x) => x.dst.node === this && x.dst.channel === "attn",
		);
		const src = clearOnly ? null : e?.src.node;
		let changed = false;
		// a rewired/removed previous target must not keep a stale 1-head
		// tap that every OTHER viewer of that block then suffers
		if (this._syncTarget && this._syncTarget !== src
			&& this._syncTarget.params?.attn_heads !== undefined) {
			delete this._syncTarget.params.attn_heads;
			changed = true;
		}
		if (this._syncTarget && !this.selective
			&& this._syncTarget.params?.attn_heads !== undefined) {
			delete this._syncTarget.params.attn_heads;
			changed = true;
		}
		this._syncTarget = null;
		if (src && src.kind === "net_node" && src.params
			&& this.selective) {
			// clamp to the last seen head count: an out-of-range index
			// would fail the whole server eval instead of rendering
			let head = Math.max(0, this.head | 0);
			if (this.numHeads) head = Math.min(head, this.numHeads - 1);
			const want = JSON.stringify([head]);
			if ((src.params.attn_heads || "") !== want) {
				src.params.attn_heads = want;
				changed = true;
			}
			this._syncTarget = src;
		}
		if (changed) Context.changed();
	}

	/** Node deletion hook (graph.js removeNode): release the upstream
	 * block's selective-tap param. */
	onRemoved() {
		this.syncUpstream(true);
	}

	buildContent(el) {
		const h = labeledInput("head", String(this.head), (v) => {
			this.head = Number(v) | 0;
			if (this.selective) this.syncUpstream();
			this.redraw();
		}, 3);
		this.headInput = h.input;
		const q = labeledInput("query tok", String(this.query), (v) => {
			this.query = Number(v) | 0;
			this.redraw();
		}, 4);
		const sel = document.createElement("label");
		const cb = document.createElement("input");
		cb.type = "checkbox";
		cb.checked = this.selective;
		cb.addEventListener("change", () => {
			this.selective = cb.checked;
			this.syncUpstream();
		});
		sel.append(cb, document.createTextNode(" ship only this head"));
		sel.title = "tap just the viewed head server-side (attn_heads)";
		// head grid: every head at once, click one to select it
		this.headGrid = document.createElement("div");
		this.headGrid.className = "multiview-grid";
		this.headGrid.title = "all heads (click to select)";
		this.canvas = document.createElement("canvas");
		this.full = document.createElement("canvas");
		this.full.title = "full N x N map";
		el.append(h.wrap, q.wrap, sel, this.headGrid, this.canvas,
			this.full);
	}

	isViewer() {
		return true;
	}

	onInputs(read) {
		// a wired rollout map [B,N,N] / [N,N] wins over raw attention
		const r = read("r");
		let t;
		if (r) {
			t = r.dims.length === 2
				? { dims: [1, ...r.dims], data: r.data }
				: r; // [B,N,N] renders as H=B "heads" (first sample = head 0)
		} else {
			t = read("attn");
			// remember the model's TRUE head count from a full tap: the
			// selective clamp and grid-local mapping need it
			if (t?.dims.length === 4 && !this.selective) {
				this.numHeads = t.dims[1];
			}
		}
		// a transient failed eval routes null: keep the last render
		// instead of blanking every thumbnail on a network blip
		if (!t && this.t) return;
		this.t = t;
		this.buildGrid(); // thumbnails only change with the tensor
		this.redraw();
	}

	/** Normalize to [H,N,N] (first sample of [B,H,N,N]), or null. */
	maps() {
		return attnMaps(this.t);
	}

	buildGrid() {
		// one thumbnail per head; rebuilt only when the tensor changes —
		// head/query edits just retoggle the selection class (a full
		// rebuild re-normalizes H*N*N floats per keystroke)
		this.headGrid.textContent = "";
		const m = this.maps();
		if (!m) return;
		const [H] = m.dims;
		const cols = headGridCols(H);
		this.headGrid.style.gridTemplateColumns = `repeat(${cols}, 1fr)`;
		for (let hi = 0; hi < H; hi++) {
			const thumb = document.createElement("canvas");
			thumb.title = `head ${hi}`;
			thumb.className = "head-thumb";
			drawTensor(thumb, headMap(m, hi), Math.max(32, 160 / cols));
			thumb.addEventListener("click", () => {
				// selective mode ships ONE head: the grid is local space
				// (always index 0), so clicks don't move the GLOBAL head
				if (this.selective) return;
				this.head = hi;
				if (this.headInput) this.headInput.value = String(hi);
				this.redraw();
			});
			this.headGrid.append(thumb);
		}
	}

	redraw() {
		const m = this.maps();
		if (!m) return;
		const [H, N] = m.dims;
		const head = Math.min(this.head, H - 1);
		const hm = headMap(m, head);
		[...this.headGrid.children].forEach((el, hi) =>
			el.classList.toggle("selected", hi === head),
		);
		// full map heatmap
		drawTensor(this.full, hm, 128);
		// one query row as a spatial grid (skip CLS col), e.g. 196 -> 14x14
		const grid = queryRowGrid(hm.data, N, this.query);
		if (grid) drawTensor(this.canvas, grid, 112);
	}
}

export class OverlayNode extends Node {
	// Attention/rollout heat composited onto the source image: wire the
	// image into "o" and a block's rollout ("r") or attention tap into "r".
	// The token row for `query` (CLS by default, minus the CLS column) is
	// bilinearly upsampled to the image size and alpha-blended as a
	// red→yellow heat ramp. Pure client-side (canvas) compositing.
	constructor(inst) {
		super("overlay", "rollout overlay");
		this.addInput("o");
		this.addInput("r");
		this.query = Number(inst?.query ?? 0);
		this.alpha = Number(inst?.alpha ?? 0.6);
	}

	buildContent(el) {
		const q = labeledInput("query tok", String(this.query), (v) => {
			this.query = Number(v) | 0;
			this.redraw();
		}, 4);
		const a = labeledInput("alpha", String(this.alpha), (v) => {
			this.alpha = Math.min(1, Math.max(0, Number(v) || 0));
			this.redraw();
		}, 4);
		this.canvas = document.createElement("canvas");
		el.append(q.wrap, a.wrap, this.canvas);
	}

	isViewer() {
		return true;
	}

	serializeExtra() {
		return { query: this.query, alpha: this.alpha };
	}

	onInputs(read) {
		this.img = read("o");
		this.map = read("r");
		this.redraw();
	}

	redraw() {
		// bilinear upsample + red->yellow alpha composite (render.js,
		// fixture-pinned against the Python transliteration)
		const res = overlayRGBA(this.img, this.map, this.query, this.alpha);
		if (!res) return;
		this.canvas.width = res.w;
		this.canvas.height = res.h;
		const scale = Math.min(1, 224 / Math.max(res.h, res.w));
		this.canvas.style.width = `${Math.round(res.w * scale)}px`;
		this.canvas.style.height = `${Math.round(res.h * scale)}px`;
		this.canvas
			.getContext("2d")
			.putImageData(new ImageData(res.rgba, res.w, res.h), 0, 0);
	}
}

// ---- op nodes (server-evaluated) -----------------------------------------------------

export class CosNode extends Node {
	constructor(inst) {
		super("cos");
		this.addInput("o");
		this.addOutput("o");
		this.A = inst?.A ?? "1.0";
		this.b = inst?.b ?? "0.0";
	}

	buildContent(el) {
		const a = labeledInput("A", this.A, (v) => {
			this.A = v;
			Context.changed();
		}, 4);
		const b = labeledInput("b", this.b, (v) => {
			this.b = v;
			Context.changed();
		}, 4);
		el.append(a.wrap, b.wrap);
	}

	serializeExtra() {
		return { A: this.A, b: this.b };
	}

	wireSpec() {
		return { endpoint: "cos", params: { A: String(this.A), b: String(this.b) } };
	}
}

export class BinOpNode extends Node {
	constructor(inst) {
		super("binop");
		this.addInput("a");
		this.addInput("b");
		this.addOutput("c");
		this.op = inst?.op ?? "+";
	}

	buildContent(el) {
		const sel = document.createElement("select");
		for (const op of ["+", "-", "*", "/"]) {
			const o = document.createElement("option");
			o.value = op;
			o.textContent = op;
			sel.append(o);
		}
		sel.value = this.op;
		sel.addEventListener("change", () => {
			this.op = sel.value;
			Context.changed();
		});
		el.append(sel);
	}

	serializeExtra() {
		return { op: this.op };
	}

	wireSpec() {
		return { endpoint: "binop", params: { op: this.op } };
	}
}

function parseSliceSpec(text) {
	// "1, :, :" -> fixed/free in the reference schema (nodes/index.js:90-194)
	const parts = text.split(",").map((s) => s.trim());
	const fixed = [];
	const free = [];
	let outDim = 0;
	parts.forEach((p, dim) => {
		if (p === ":" || p === "") {
			free.push({ in_dim: dim, out_dim: outDim++ });
		} else {
			fixed.push({ dim, val: Number(p) | 0 });
		}
	});
	return { fixed, free };
}

function sliceSpecText(fixed, free) {
	const n = fixed.length + free.length;
	const parts = new Array(n).fill(":");
	for (const f of fixed) parts[f.dim] = String(f.val);
	return parts.join(", ");
}

export class SliceNode extends Node {
	constructor(inst) {
		super("slice");
		this.addInput("o");
		this.addOutput("o");
		this.fixed = inst?.fixed ?? [{ dim: 0, val: 0 }];
		this.free = inst?.free ?? [
			{ in_dim: 1, out_dim: 0 },
			{ in_dim: 2, out_dim: 1 },
		];
	}

	buildContent(el) {
		const f = labeledInput(
			"y = x[",
			sliceSpecText(this.fixed, this.free),
			(v) => {
				const spec = parseSliceSpec(v);
				this.fixed = spec.fixed;
				this.free = spec.free;
				Context.changed();
			},
			10,
		);
		el.append(f.wrap, document.createTextNode("]"));
	}

	serializeExtra() {
		return { fixed: this.fixed, free: this.free };
	}

	wireSpec() {
		return {
			endpoint: "slice",
			params: {
				fixed: JSON.stringify(this.fixed),
				free: JSON.stringify(this.free),
			},
		};
	}
}

export class ShuffleNode extends Node {
	constructor(inst) {
		super("shuffle");
		this.addInput("o");
		this.addOutput("o");
		this.free = inst?.free ?? [
			{ in_dim: 1, out_dim: 0 },
			{ in_dim: 0, out_dim: 1 },
		];
	}

	buildContent(el) {
		const order = [...this.free]
			.sort((a, b) => a.out_dim - b.out_dim)
			.map((f) => f.in_dim)
			.join(", ");
		const f = labeledInput("dim order", order, (v) => {
			const dims = v.split(",").map((s) => Number(s.trim()) | 0);
			this.free = dims.map((inDim, outDim) => ({
				in_dim: inDim,
				out_dim: outDim,
			}));
			Context.changed();
		});
		el.append(f.wrap);
	}

	serializeExtra() {
		return { fixed: [], free: this.free };
	}

	wireSpec() {
		return {
			endpoint: "shuffle",
			params: { fixed: "[]", free: JSON.stringify(this.free) },
		};
	}
}

export class ConstNode extends Node {
	constructor(inst) {
		super("const");
		this.addOutput("o");
		this.value = inst?.value ?? 1;
		this.dims = inst?.dims ?? [100, 100];
	}

	buildContent(el) {
		const v = labeledInput("value", String(this.value), (x) => {
			this.value = Number(x);
			Context.changed();
		}, 5);
		const d = labeledInput("dims", this.dims.join(","), (x) => {
			this.dims = x.split(",").map((s) => Number(s.trim()) | 0);
			Context.changed();
		});
		el.append(v.wrap, d.wrap);
	}

	serializeExtra() {
		return { value: this.value, dims: this.dims };
	}

	wireSpec() {
		return {
			endpoint: "const",
			params: {
				value: String(this.value),
				dims: JSON.stringify(this.dims),
			},
		};
	}
}

export class NoiseNode extends Node {
	constructor(inst) {
		super("noise");
		this.addOutput("o");
		this.dims = inst?.dims ?? [100, 100];
		this.seed = inst?.seed ?? 0;
	}

	buildContent(el) {
		const d = labeledInput("dims", this.dims.join(","), (x) => {
			this.dims = x.split(",").map((s) => Number(s.trim()) | 0);
			Context.changed();
		});
		const btn = document.createElement("button");
		btn.textContent = "reroll";
		btn.addEventListener("click", () => {
			this.seed = (this.seed + 1) | 0;
			Context.changed();
		});
		el.append(d.wrap, btn);
	}

	serializeExtra() {
		return { dims: this.dims, seed: this.seed };
	}

	wireSpec() {
		return {
			endpoint: "noise",
			params: { dims: JSON.stringify(this.dims), seed: String(this.seed) },
		};
	}
}

export class Conv2dNode extends Node {
	constructor(inst) {
		super("conv2d", "conv 2d");
		this.addInput("o");
		this.addOutput("o");
		this.h = Number(inst?.h ?? 3);
		this.w = Number(inst?.w ?? 3);
		if (inst?.matrix) {
			const raw = atob(inst.matrix);
			const bytes = new Uint8Array(raw.length);
			for (let i = 0; i < raw.length; i++) bytes[i] = raw.charCodeAt(i);
			this.matrix = Array.from(new Float32Array(bytes.buffer));
		} else {
			this.matrix = new Array(this.h * this.w).fill(0);
			this.matrix[Math.floor((this.h * this.w) / 2)] = 1;
		}
	}

	buildContent(el) {
		this.tableWrap = document.createElement("div");
		el.append(this.tableWrap);
		this.renderTable();
	}

	renderTable() {
		this.tableWrap.textContent = "";
		const table = document.createElement("table");
		table.className = "conv-matrix";
		for (let i = 0; i < this.h; i++) {
			const tr = document.createElement("tr");
			for (let j = 0; j < this.w; j++) {
				const td = document.createElement("td");
				const input = document.createElement("input");
				input.size = 3;
				input.value = String(this.matrix[i * this.w + j]);
				input.addEventListener("change", () => {
					this.matrix[i * this.w + j] = Number(input.value) || 0;
					Context.changed();
				});
				td.append(input);
				tr.append(td);
			}
			table.append(tr);
		}
		this.tableWrap.append(table);
	}

	matrixB64() {
		const f32 = new Float32Array(this.matrix);
		return btoa(String.fromCharCode(...new Uint8Array(f32.buffer)));
	}

	serializeExtra() {
		return { matrix: this.matrixB64(), w: this.w, h: this.h };
	}

	wireSpec() {
		return {
			endpoint: "conv2d",
			params: {
				matrix: this.matrixB64(),
				w: String(this.w),
				h: String(this.h),
			},
		};
	}
}

export class ResizeNode extends Node {
	constructor(inst) {
		super("resize");
		this.addInput("o");
		this.addOutput("o");
		this.dims = inst?.dims ?? [224, 224];
	}

	buildContent(el) {
		const d = labeledInput("H,W", this.dims.join(","), (x) => {
			this.dims = x.split(",").map((s) => Number(s.trim()) | 0);
			Context.changed();
		});
		el.append(d.wrap);
	}

	serializeExtra() {
		return { dims: this.dims };
	}

	wireSpec() {
		return {
			endpoint: "resize",
			params: { dims: JSON.stringify(this.dims) },
		};
	}
}

// ---- server layer node (net_node contract) -------------------------------------------

export class NetNode extends Node {
	// endpoint -> {io, contents}; filled by prefetch() (ONE /descriptions
	// request for a whole graph load, vs the reference's 2 GETs per node —
	// its 42-node vgg16 load fired ~84 sequential requests)
	static metadataCache = new Map();

	constructor(endpoint, params, io, contentsHtml) {
		super("net_node", endpoint);
		this.endpoint = endpoint;
		this.params = params || {};
		for (const ch of io.ins) this.addInput(ch);
		for (const ch of io.outs) this.addOutput(ch);
		this.contentsHtml = contentsHtml;
	}

	static async prefetch(endpoints) {
		const missing = [...new Set(endpoints)].filter(
			(e) => !NetNode.metadataCache.has(e),
		);
		if (!missing.length) return;
		try {
			const out = await (
				await fetch(`descriptions?names=${missing.join(",")}`)
			).json();
			for (const [name, meta] of Object.entries(out)) {
				if (!meta.error) NetNode.metadataCache.set(name, meta);
			}
		} catch (e) {
			console.warn("batched metadata prefetch failed", e);
		}
	}

	static async create(endpoint, params = {}) {
		const cached = NetNode.metadataCache.get(endpoint);
		if (cached && !Object.keys(params).length) {
			return new NetNode(endpoint, params, cached.io, cached.contents);
		}
		const qs = new URLSearchParams(params).toString();
		const resp = await fetch(`description/${endpoint}${qs ? `?${qs}` : ""}`);
		if (!resp.ok) throw new Error(await resp.text());
		const io = await resp.json();
		let html = "";
		try {
			const cresp = await fetch(`contents/${endpoint}${qs ? `?${qs}` : ""}`);
			// a non-ok body is the server's ERROR TEXT — rendering it as
			// the node UI (and never offering retry) would be wrong
			html = cresp.ok ? await cresp.text() : "";
		} catch {
			html = ""; // retry button offered in buildContent
		}
		return new NetNode(endpoint, params, io, html);
	}

	buildContent(el) {
		if (this.contentsHtml) {
			el.innerHTML = this.contentsHtml;
			this.bindContents(el);
			return;
		}
		// metadata fetch failed: offer a Retry (reference contract,
		// net_node.js:415-421)
		const retry = document.createElement("button");
		retry.textContent = "retry";
		retry.addEventListener("click", async () => {
			try {
				const qs = new URLSearchParams(this.params).toString();
				const resp = await fetch(
					`contents/${this.endpoint}${qs ? `?${qs}` : ""}`,
				);
				if (resp.ok) {
					this.contentsHtml = await resp.text();
					el.textContent = "";
					el.innerHTML = this.contentsHtml;
					// wire up the freshly injected [data-param]/[data-matrix]
					// editors — without this the retried UI is inert
					this.bindContents(el);
				}
			} catch {}
		});
		el.append(document.createTextNode(this.endpoint), retry);
	}

	/**
	 * Bind server-delivered editable UI (the contents/ contract): any
	 * [data-param] element writes its value into this.params and
	 * re-evaluates; a [data-matrix] table of [data-cell] inputs re-encodes
	 * to the base64 f32 matrix param (conv2d). The reference rendered its
	 * editors client-side per node class; here the SERVER ships the editor
	 * HTML, so plugin nodes get editable UIs with zero frontend code.
	 */
	bindContents(el) {
		for (const input of el.querySelectorAll("[data-param]")) {
			const name = input.dataset.param;
			if (this.params[name] !== undefined) input.value = this.params[name];
			input.addEventListener("change", async () => {
				this.params[name] = input.value;
				// a size param on a matrix-bearing node (conv2d h/w) must
				// resize the stored matrix and re-render the editor —
				// otherwise the stale base64 matrix 400s every eval with a
				// server-side reshape error
				const table = el.querySelector("[data-matrix]");
				if (table && (name === "h" || name === "w")) {
					this.resizeMatrix(table);
					await this.refreshContents(el);
				}
				Context.changed();
			});
		}
		for (const table of el.querySelectorAll("[data-matrix]")) {
			const reencode = () => {
				const h = Number(table.dataset.h);
				const w = Number(table.dataset.w);
				const m = new Float32Array(h * w);
				for (const cell of table.querySelectorAll("[data-cell]")) {
					const [i, j] = cell.dataset.cell.split(",").map(Number);
					m[i * w + j] = Number(cell.value) || 0;
				}
				this.params.matrix = btoa(
					String.fromCharCode(...new Uint8Array(m.buffer)),
				);
				Context.changed();
			};
			for (const cell of table.querySelectorAll("[data-cell]")) {
				cell.addEventListener("change", reencode);
			}
		}
	}

	/** Crop/zero-pad the base64 f32 matrix param to the current h/w
	 * params, preserving the overlapping cells. */
	resizeMatrix(table) {
		const oh = Number(table.dataset.h);
		const ow = Number(table.dataset.w);
		const nh = Number(this.params.h) || oh;
		const nw = Number(this.params.w) || ow;
		if (!this.params.matrix || (nh === oh && nw === ow)) return;
		const bytes = Uint8Array.from(atob(this.params.matrix), (c) =>
			c.charCodeAt(0),
		);
		const m = new Float32Array(bytes.buffer);
		const out = new Float32Array(nh * nw);
		for (let i = 0; i < Math.min(oh, nh); i++) {
			for (let j = 0; j < Math.min(ow, nw); j++) {
				out[i * nw + j] = m[i * ow + j] || 0;
			}
		}
		this.params.matrix = btoa(
			String.fromCharCode(...new Uint8Array(out.buffer)),
		);
	}

	/** Refetch the server-rendered editor for the CURRENT params and
	 * re-bind it (the server owns the UI; re-render = refetch). */
	async refreshContents(el) {
		try {
			const qs = new URLSearchParams(this.params).toString();
			const resp = await fetch(
				`contents/${this.endpoint}${qs ? `?${qs}` : ""}`,
			);
			if (resp.ok) {
				this.contentsHtml = await resp.text();
				el.innerHTML = this.contentsHtml;
				this.bindContents(el);
			}
		} catch {}
	}

	serializeExtra() {
		return { endpoint: this.endpoint, params: this.params };
	}

	wireSpec() {
		return { endpoint: this.endpoint, params: this.params };
	}
}

// ---- registration --------------------------------------------------------------------

export function registerAll() {
	const simple = (Cls) => ({ make: async (inst) => new Cls(inst) });
	Context.registerKind("img_src", simple(ImgSourceNode));
	Context.registerKind("img_view", simple(ImgViewNode));
	Context.registerKind("multi_view", simple(MultiViewNode));
	Context.registerKind("attn_view", simple(AttnViewNode));
	Context.registerKind("overlay", simple(OverlayNode));
	Context.registerKind("category", {
		make: async (inst) => new CategoryNode(inst?.cats),
	});
	Context.registerKind("cos", simple(CosNode));
	Context.registerKind("binop", simple(BinOpNode));
	Context.registerKind("slice", simple(SliceNode));
	Context.registerKind("shuffle", simple(ShuffleNode));
	Context.registerKind("const", simple(ConstNode));
	Context.registerKind("noise", simple(NoiseNode));
	Context.registerKind("conv2d", simple(Conv2dNode));
	Context.registerKind("resize", simple(ResizeNode));
	Context.registerKind("net_node", {
		make: async (inst) => NetNode.create(inst.endpoint, inst.params),
		prefetch: (instances) =>
			NetNode.prefetch(instances.map((i) => i.endpoint)),
	});
}
