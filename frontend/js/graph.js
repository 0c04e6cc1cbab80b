// Client graph engine: nodes, ports, edges, serialization, server eval.
//
// Same public contract as the reference client engine
// (/root/reference/main/static/main/graph.js): draggable node boxes with
// click-to-wire ports, cycle-checked edges, dirty-set scheduled evaluation,
// JSON (de)serialization in the reference schema. One deliberate
// architecture change (the reference's own roadmap, todo.md:13): model
// compute ships to the server as one /compute request — but cheap
// viewer-local ops whose whole ancestry is client-held evaluate HERE via
// localops.js (zero round trip, the reference gpu.js capability).

import { compute } from "./wire.js";
import { LocalFallback, evalLocal } from "./localops.js";
import {
	localSet as pureLocalSet,
	planRequest,
	readySet as pureReadySet,
} from "./partition.js";

let nextId = 1;

export class Port {
	constructor(node, channel, direction) {
		this.node = node;
		this.channel = channel;
		this.direction = direction; // "in" | "out"
		this.el = null;
	}
}

export class Edge {
	constructor(src, dst) {
		this.src = src; // out-port
		this.dst = dst; // in-port
		this.path = null;
	}
}

export class Node {
	/** @param {string} kind */
	constructor(kind, title = null) {
		this.kind = kind;
		this.id = nextId++;
		this.title = title || kind;
		this.x = 0;
		this.y = 0;
		this.el = null;
		this.contentEl = null;
		this.statusEl = null;
		this.ins = [];
		this.outs = [];
	}

	addInput(ch) {
		this.ins.push(new Port(this, ch, "in"));
	}

	addOutput(ch) {
		this.outs.push(new Port(this, ch, "out"));
	}

	inPort(ch) {
		return this.ins.find((p) => p.channel === ch);
	}

	outPort(ch) {
		return this.outs.find((p) => p.channel === ch);
	}

	// ---- overridables -------------------------------------------------------
	/** Build the node body DOM into el. */
	buildContent(el) {}

	/** Kind-specific serialized instance (merged with {kind}). */
	serializeExtra() {
		return {};
	}

	/** True if this node provides a client-side tensor (image source). */
	isSource() {
		return false;
	}

	/** For sources: {dims, data} f32 tensor, or null if not ready. */
	sourceTensor() {
		return null;
	}

	/** True if excluded from the server request (pure viewer sink). */
	isViewer() {
		return false;
	}

	/** Server endpoint + params for the request ("net node" contract). */
	wireSpec() {
		return { endpoint: this.kind, params: {} };
	}

	/** Called after eval with (channel) => tensor for this node's inputs. */
	onInputs(read) {}

	/** Called after eval with (channel) => tensor for this node's outputs. */
	onOutputs(read) {}

	/**
	 * @param {string} text compact status label
	 * @param {boolean} isError
	 * @param {string | null} detail full text shown in a hover tooltip
	 *   pinned to the status element (reference graph.js:498-514 shows
	 *   "Error!" inline and the full server error on hover, hover.js:4-36)
	 */
	setStatus(text, isError = false, detail = null) {
		if (this.statusEl) {
			this.statusEl.textContent = text;
			this.statusEl.classList.toggle("error", isError);
			statusHover.bind(this.statusEl, detail);
		}
	}
}

/** Singleton floating tooltip for status details (reference hover.js). */
const statusHover = {
	div: null,
	// per-element detail text; mouseenter reads the CURRENT value so a
	// re-eval that clears the error also kills a stale tooltip
	details: new WeakMap(),
	ensure() {
		if (this.div) return;
		this.div = document.createElement("div");
		this.div.className = "hover-detail";
		this.div.style.visibility = "hidden";
		document.body.append(this.div);
	},
	bind(el, detail) {
		this.ensure();
		const first = !this.details.has(el);
		this.details.set(el, detail);
		if (detail == null) this.div.style.visibility = "hidden";
		if (!first) return;
		el.addEventListener("mouseenter", () => {
			const text = this.details.get(el);
			if (text == null) return;
			this.div.textContent = text;
			const rect = el.getBoundingClientRect();
			this.div.style.left = `${rect.left}px`;
			this.div.style.top = `${rect.bottom}px`;
			this.div.style.visibility = "visible";
		});
		el.addEventListener("mouseleave", () => {
			this.div.style.visibility = "hidden";
		});
	},
};

export class Context {
	static nodes = [];
	static edges = [];
	static kinds = new Map(); // kind -> {make: async (instance|null) => Node}
	static onChange = null; // set by app.js -> schedules eval
	static container = null;
	static svg = null;
	static respDtype = "bf16"; // wire tap dtype ("f32" = reference-exact)

	static registerKind(kind, factory) {
		Context.kinds.set(kind, factory);
	}

	static async createNode(kind, instance = null) {
		const factory = Context.kinds.get(kind);
		if (!factory) {
			console.warn("unknown node kind", kind);
			return null;
		}
		return Context.addNodeInstance(await factory.make(instance));
	}

	/** Adopt an already-constructed Node into the graph + DOM. */
	static addNodeInstance(node) {
		Context.snapshot();
		Context.nodes.push(node);
		renderNode(node);
		Context.changed();
		return node;
	}

	static removeNode(node) {
		Context.snapshot();
		const s = Context.suppressHistory;
		Context.suppressHistory = true;
		try {
			Context.edges
				.filter((e) => e.src.node === node || e.dst.node === node)
				.forEach((e) => Context.disconnect(e));
		} finally {
			Context.suppressHistory = s;
		}
		Context.nodes = Context.nodes.filter((n) => n !== node);
		Context.selection.delete(node);
		node.el?.remove();
		// lifecycle hook: nodes holding state on OTHER nodes (attn_view's
		// selective-tap param on its upstream block) release it here
		node.onRemoved?.();
		Context.changed();
	}

	static wouldCycle(srcNode, dstNode) {
		// DFS from dstNode along out-edges; reaching srcNode => cycle
		const seen = new Set();
		const stack = [dstNode];
		while (stack.length) {
			const n = stack.pop();
			if (n === srcNode) return true;
			if (seen.has(n)) continue;
			seen.add(n);
			for (const e of Context.edges) {
				if (e.src.node === n) stack.push(e.dst.node);
			}
		}
		return false;
	}

	static connect(srcPort, dstPort) {
		if (srcPort.direction !== "out" || dstPort.direction !== "in") return null;
		if (Context.wouldCycle(srcPort.node, dstPort.node)) {
			console.warn("edge would create a cycle");
			return null;
		}
		Context.snapshot();
		// one edge per input channel: replace existing
		const existing = Context.edges.find((e) => e.dst === dstPort);
		if (existing) {
			const s = Context.suppressHistory;
			Context.suppressHistory = true;
			try {
				Context.disconnect(existing);
			} finally {
				Context.suppressHistory = s;
			}
		}
		const edge = new Edge(srcPort, dstPort);
		Context.edges.push(edge);
		renderEdge(edge);
		Context.changed();
		return edge;
	}

	static disconnect(edge) {
		Context.snapshot();
		Context.edges = Context.edges.filter((e) => e !== edge);
		edge.path?.remove();
		Context.changed();
	}

	static changed() {
		// any mutation (structural or param) invalidates in-flight
		// results: a slow /compute can outlive the debounce
		// window, and routing a stale response onto a mutated/reloaded
		// graph blanks viewers and marks detached nodes "ok"
		Context.evalEpoch++;
		Context.onChange?.();
	}

	// ---- undo/redo (snapshot-based over the serialization schema) -------------
	static history = [];
	static redoStack = [];
	static suppressHistory = false;

	/** Push the current graph state; call at the START of a structural
	 * mutation. Nested mutations (removeNode's edge cleanup, connect's
	 * replace-existing) run with history suppressed so one user gesture is
	 * one undo step. */
	static snapshot() {
		if (Context.suppressHistory) return;
		Context.history.push(JSON.stringify(Context.serialize()));
		if (Context.history.length > 50) Context.history.shift();
		Context.redoStack.length = 0;
	}

	static async _restore(json) {
		const s = Context.suppressHistory;
		Context.suppressHistory = true;
		try {
			await Context.deserialize(JSON.parse(json));
		} finally {
			Context.suppressHistory = s;
		}
	}

	static async undo() {
		if (!Context.history.length) return;
		Context.redoStack.push(JSON.stringify(Context.serialize()));
		await Context._restore(Context.history.pop());
	}

	static async redo() {
		if (!Context.redoStack.length) return;
		Context.history.push(JSON.stringify(Context.serialize()));
		await Context._restore(Context.redoStack.pop());
	}

	// ---- multi-select -----------------------------------------------------------
	static selection = new Set();

	static toggleSelect(node) {
		if (Context.selection.has(node)) {
			Context.selection.delete(node);
			node.el?.classList.remove("selected");
		} else {
			Context.selection.add(node);
			node.el?.classList.add("selected");
		}
	}

	static clearSelection() {
		for (const n of Context.selection) n.el?.classList.remove("selected");
		Context.selection.clear();
	}

	static removeSelected() {
		if (!Context.selection.size) return;
		Context.snapshot();
		const s = Context.suppressHistory;
		Context.suppressHistory = true;
		try {
			for (const n of [...Context.selection]) Context.removeNode(n);
		} finally {
			Context.suppressHistory = s;
			Context.selection.clear();
		}
	}

	// ---- evaluation -----------------------------------------------------------
	static evalEpoch = 0;

	/** Plain-data description of the live graph for the pure partition
	 * rule (partition.js) — the ONE implementation shared with the
	 * fixture replay, so the routing decision is pinned by
	 * tests/fixtures/partition_fixtures.json. */
	static describe() {
		const nIndex = new Map(Context.nodes.map((n, i) => [n, i]));
		const nodes = Context.nodes.map((n) => ({
			kind: n.kind,
			source: n.isSource(),
			viewer: n.isViewer(),
			hasTensor: n.isSource() && n.sourceTensor() !== null,
			ins: n.ins.map((p) => p.channel),
		}));
		const edges = Context.edges.map((e) => ({
			src: { node: nIndex.get(e.src.node), channel: e.src.channel },
			dst: { node: nIndex.get(e.dst.node), channel: e.dst.channel },
		}));
		return { nodes, edges };
	}

	/** Nodes whose inputs are all satisfied (transitively). A half-wired
	 * node (just dropped on the canvas) must not 400 the whole request —
	 * the reference evaluated per-node with isolation; we stage one
	 * program, so incomplete nodes are excluded up front and labeled. */
	static readySet() {
		const r = pureReadySet(Context.describe());
		return new Map(Context.nodes.map((n, i) => [n, r[i]]));
	}

	/** Nodes evaluable client-side this pass: kind has a local impl, the
	 * whole input ancestry is client-held (sources with tensors or other
	 * local nodes), and NO descendant needs the server (a local op
	 * feeding a model node must be computed server-side anyway). */
	static localSet(ready) {
		const g = Context.describe();
		const s = pureLocalSet(
			g,
			Context.nodes.map((n) => ready.get(n)),
		);
		return new Set([...s].map((i) => Context.nodes[i]));
	}

	static async evaluate() {
		const epoch = ++Context.evalEpoch;
		const ready = Context.readySet();

		// zero-round-trip pass: evaluate viewer-local cheap ops here
		const localSet = Context.localSet(ready);
		const localResults = new Map(); // node -> Map(ch -> tensor)
		const evalOne = (n) => {
			const got = localResults.get(n);
			if (got) return got;
			const res = evalLocal(
				n.kind,
				{ kind: n.kind, ...n.serializeExtra() },
				(ch) => {
					const e = Context.edges.find(
						(x) => x.dst.node === n && x.dst.channel === ch,
					);
					if (!e) return null;
					const src = e.src.node;
					if (src.isSource()) return src.sourceTensor();
					return evalOne(src)?.get(e.src.channel) ?? null;
				},
			);
			localResults.set(n, res);
			return res;
		};
		try {
			for (const n of localSet) evalOne(n);
		} catch (err) {
			// ANY local failure (broadcast binop, odd ranks, malformed
			// params): fall back to the server for the WHOLE pass — the
			// server returns attributed per-node errors, and correctness
			// beats the saved round trip. A non-LocalFallback here is a
			// localops bug, worth a console line but never a dead eval.
			if (!(err instanceof LocalFallback)) {
				console.error("local eval bug, falling back to server:", err);
			}
			localSet.clear();
			localResults.clear();
		}
		Context.localResults = localResults;

		// server request: every READY non-source non-viewer non-local node,
		// planned by the shared pure rule (partition.js planRequest —
		// explicit taps so only what viewers render leaves the device,
		// source tensors deduped so one img_src ships its payload once)
		const g = Context.describe();
		const readyArr = Context.nodes.map((n) => ready.get(n));
		const localIdx = new Set();
		Context.nodes.forEach((n, i) => {
			if (localSet.has(n)) localIdx.add(i);
		});
		const plan = planRequest(g, readyArr, localIdx);
		const reqNodes = plan.req.map((i) => Context.nodes[i]);
		const index = new Map(reqNodes.map((n, i) => [n, i]));
		const nodesJson = reqNodes.map((n) => n.wireSpec());
		const taps = plan.taps;
		const edgesJson = plan.edges;
		const tensors = plan.tensors.map((i) => Context.nodes[i].sourceTensor());

		for (const n of Context.nodes) {
			if (localSet.has(n)) {
				n.setStatus("ok (local)");
			} else if (!n.isSource() && !n.isViewer() && !ready.get(n)) {
				n.setStatus("awaiting inputs");
			} else {
				n.setStatus(reqNodes.length ? "…" : "");
			}
		}
		if (!reqNodes.length) {
			Context.routeResults(new Map(), index, epoch);
			return;
		}

		try {
			// ALWAYS send taps (even []): omitting the field makes the
			// server fall back to its harvest-everything "primary" policy
			// — for a viewer-less 24-block chain that ships tens of MB of
			// intermediates over the network per eval for nothing
			const reqJson = { nodes: nodesJson, edges: edgesJson, taps };
			// viewer taps are render data: bf16 blocks halve response bytes
			// over the wire (negotiated extension, docs/wire_protocol.md);
			// Context.respDtype = "f32" restores reference-exact payloads
			const outputs = await compute(reqJson, tensors, {
				respDtype: Context.respDtype,
			});
			if (epoch !== Context.evalEpoch) return; // stale
			Context.routeResults(outputs, index, epoch);
			for (const n of reqNodes) n.setStatus("ok");
			// sources/viewers were set to the "…" busy marker above and
			// are not in reqNodes — clear them or they stay busy forever
			for (const n of Context.nodes) {
				if (n.isSource() || n.isViewer()) n.setStatus("");
			}
		} catch (err) {
			if (epoch !== Context.evalEpoch) return;
			const msg = String(err.message || err);
			// locally-computed branches stay alive through a server
			// failure: route their tensors to their viewers and keep
			// their "ok (local)" status — the zero-round-trip feature
			// matters MOST when the network is flaky
			Context.routeResults(new Map(), index, epoch);
			// per-node error attribution: "node <i> (<name>): ..."
			const m = msg.match(/node (\d+)/);
			for (const n of Context.nodes) {
				if (!localSet.has(n)) n.setStatus("");
			}
			if (m) {
				const bad = reqNodes[Number(m[1])];
				// reference parity (graph.js:498-514 + hover.js): compact
				// "Error!" at the failing node with the FULL server error
				// text on hover; only DOWNSTREAM nodes get the "eval
				// error upstream" label (run_eager's propagation
				// semantics) — siblings/ancestors keep their state
				bad?.setStatus("Error!", true, msg);
				const downstream = new Set();
				if (bad) {
					const queue = [bad];
					while (queue.length) {
						const cur = queue.pop();
						for (const e of Context.edges) {
							if (e.src.node === cur && !downstream.has(e.dst.node)) {
								downstream.add(e.dst.node);
								queue.push(e.dst.node);
							}
						}
					}
				}
				for (const n of reqNodes) {
					if (n !== bad && downstream.has(n)) {
						n.setStatus("eval error upstream", false);
					}
				}
			} else {
				for (const n of reqNodes) n.setStatus("Error!", true, msg);
			}
			console.error("eval failed:", msg);
		}
	}

	static routeResults(outputs, index, epoch) {
		const read = (node, ch) => {
			if (node.isSource()) return node.sourceTensor();
			const local = Context.localResults?.get(node);
			if (local) return local.get(ch) ?? null;
			const i = index.get(node);
			return i === undefined ? null : (outputs.get(`${i}/${ch}`) ?? null);
		};
		for (const n of Context.nodes) {
			// inputs: follow the wired edge to its producer's tensor
			n.onInputs((ch) => {
				const e = Context.edges.find(
					(x) => x.dst.node === n && x.dst.channel === ch,
				);
				return e ? read(e.src.node, e.src.channel) : null;
			});
			n.onOutputs((ch) => read(n, ch));
			// port tooltips: shapes after eval (reference graph.js:502-507)
			for (const p of [...n.ins, ...n.outs]) {
				const t =
					p.direction === "out"
						? read(n, p.channel)
						: (() => {
								const e = Context.edges.find(
									(x) => x.dst === p,
								);
								return e ? read(e.src.node, e.src.channel) : null;
							})();
				if (p.el) p.el.title = t ? `[${t.dims.join(", ")}]` : p.channel;
			}
		}
	}

	// ---- (de)serialization (reference schema) ---------------------------------
	static serialize() {
		const index = new Map(Context.nodes.map((n, i) => [n, i]));
		return {
			nodes: Context.nodes.map((n) => ({
				instance: { kind: n.kind, ...n.serializeExtra() },
				pos: { x: n.x, y: n.y },
			})),
			edges: Context.edges.map((e) => ({
				in_port: { node: index.get(e.src.node), channel: e.src.channel },
				out_port: { node: index.get(e.dst.node), channel: e.dst.channel },
			})),
		};
	}

	static async deserialize(obj) {
		Context.snapshot(); // loading a graph is one undoable step
		const suppress = Context.suppressHistory;
		Context.suppressHistory = true;
		try {
			await Context._deserializeBody(obj);
		} finally {
			Context.suppressHistory = suppress;
		}
	}

	static async _deserializeBody(obj) {
		Context.clear();
		// batched metadata prefetch per kind (kills the reference's N+1
		// GET storm on 42-node graph loads, SURVEY.md §3.4)
		const byKind = new Map();
		for (const data of obj.nodes) {
			const kind = data.instance.kind;
			if (!byKind.has(kind)) byKind.set(kind, []);
			byKind.get(kind).push(data.instance);
		}
		await Promise.all(
			[...byKind.entries()].map(([kind, instances]) =>
				Context.kinds.get(kind)?.prefetch?.(instances),
			),
		);
		const nodes = [];
		for (const data of obj.nodes) {
			const node = await Context.createNode(
				data.instance.kind,
				data.instance,
			);
			if (node) node_move(node, data.pos.x, data.pos.y);
			nodes.push(node);
		}
		for (const e of obj.edges) {
			const src = nodes[e.in_port.node];
			const dst = nodes[e.out_port.node];
			if (!src || !dst) continue;
			const sp = src.outPort(e.in_port.channel);
			const dp = dst.inPort(e.out_port.channel);
			if (sp && dp) Context.connect(sp, dp);
		}
		Context.changed();
	}

	static clear() {
		for (const n of [...Context.nodes]) Context.removeNode(n);
		nextId = 1;
	}
}

// ---- DOM rendering ---------------------------------------------------------------

let pendingWire = null; // out-port awaiting an in-port click

function beginWire(port) {
	pendingWire = port;
	document
		.querySelectorAll(".port.pending")
		.forEach((d) => d.classList.remove("pending"));
	if (port) port.el?.classList.add("pending");
}

function portDot(port) {
	const dot = document.createElement("div");
	dot.className = `port ${port.direction}`;
	dot.title = port.channel;
	const label = document.createElement("span");
	label.textContent = port.channel;
	const wrap = document.createElement("div");
	wrap.className = `port-wrap ${port.direction}`;
	if (port.direction === "in") wrap.append(dot, label);
	else wrap.append(label, dot);
	port.el = dot;
	dot.addEventListener("click", (ev) => {
		ev.stopPropagation();
		if (port.direction === "out") {
			beginWire(pendingWire === port ? null : port);
		} else if (pendingWire) {
			Context.connect(pendingWire, port);
			beginWire(null);
		}
	});
	return wrap;
}

export function node_move(node, x, y) {
	node.x = x;
	node.y = y;
	node.el.style.left = `${x}px`;
	node.el.style.top = `${y}px`;
	redrawEdges(node);
}

function renderNode(node) {
	const el = document.createElement("div");
	el.className = "node";
	node.el = el;

	const header = document.createElement("div");
	header.className = "node-header";
	const title = document.createElement("span");
	title.textContent = node.title;
	const close = document.createElement("button");
	close.textContent = "×";
	close.className = "node-close";
	close.addEventListener("click", () => Context.removeNode(node));
	header.append(title, close);

	const insCol = document.createElement("div");
	insCol.className = "ports ins";
	for (const p of node.ins) insCol.append(portDot(p));
	const outsCol = document.createElement("div");
	outsCol.className = "ports outs";
	for (const p of node.outs) outsCol.append(portDot(p));

	const content = document.createElement("div");
	content.className = "node-content";
	node.contentEl = content;

	const status = document.createElement("div");
	status.className = "node-status";
	node.statusEl = status;

	const body = document.createElement("div");
	body.className = "node-body";
	body.append(insCol, content, outsCol);
	el.append(header, body, status);
	Context.container.append(el);
	node.buildContent(content);

	// dragging by the header; shift-click toggles multi-selection and a
	// drag on a selected node moves the whole selection together
	header.addEventListener("pointerdown", (ev) => {
		if (ev.target === close) return;
		if (ev.shiftKey) {
			ev.preventDefault();
			Context.toggleSelect(node);
			return;
		}
		ev.preventDefault();
		const startX = ev.clientX;
		const startY = ev.clientY;
		const group = Context.selection.has(node)
			? [...Context.selection]
			: [node];
		const origins = group.map((n) => ({ n, x: n.x, y: n.y }));
		const move = (mv) => {
			const scale = window.workspaceScale || 1;
			const dx = (mv.clientX - startX) / scale;
			const dy = (mv.clientY - startY) / scale;
			for (const o of origins) node_move(o.n, o.x + dx, o.y + dy);
		};
		const up = () => {
			window.removeEventListener("pointermove", move);
			window.removeEventListener("pointerup", up);
		};
		window.addEventListener("pointermove", move);
		window.addEventListener("pointerup", up);
	});
}

function portCenter(port) {
	const rect = port.el.getBoundingClientRect();
	const cRect = Context.container.getBoundingClientRect();
	const scale = window.workspaceScale || 1;
	return {
		x: (rect.x + rect.width / 2 - cRect.x) / scale,
		y: (rect.y + rect.height / 2 - cRect.y) / scale,
	};
}

function renderEdge(edge) {
	const path = document.createElementNS("http://www.w3.org/2000/svg", "path");
	path.classList.add("edge");
	// click: delete; shift-click: re-route — detach and pick the source
	// back up as the pending wire, ready to drop on another in-port
	path.addEventListener("click", (ev) => {
		const src = edge.src;
		Context.disconnect(edge);
		if (ev.shiftKey) beginWire(src);
	});
	edge.path = path;
	Context.svg.append(path);
	drawEdge(edge);
}

function drawEdge(edge) {
	const a = portCenter(edge.src);
	const b = portCenter(edge.dst);
	const dx = Math.max(40, Math.abs(b.x - a.x) / 2);
	edge.path.setAttribute(
		"d",
		`M ${a.x} ${a.y} C ${a.x + dx} ${a.y}, ${b.x - dx} ${b.y}, ${b.x} ${b.y}`,
	);
}

export function redrawEdges(node = null) {
	for (const e of Context.edges) {
		if (!node || e.src.node === node || e.dst.node === node) drawEdge(e);
	}
}
