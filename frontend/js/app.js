// Boot: wire everything, build the toolbar, save/load, model browser.
// Boot-sequence contract parity with /root/reference/main/static/main/index.js
// (minus gpu.init(): compute is server-side here).

import { Context, node_move } from "./graph.js";
import { NetNode, registerAll } from "./nodes.js";
import { Workspace } from "./workspace.js";
import { modalInput } from "./modal.js";

let evalTimer = null;

function scheduleEval() {
	clearTimeout(evalTimer);
	evalTimer = setTimeout(() => Context.evaluate(), 150);
}

async function loadGraphByName(name) {
	const resp = await fetch(`load_graph/${name}`);
	if (!resp.ok) {
		// the 400 body is plain error text, not JSON — surface it instead
		// of dying on an unhandled SyntaxError with a blank canvas
		alert(`could not load ${name}: ${await resp.text()}`);
		return;
	}
	await Context.deserialize(await resp.json());
}

function saveGraph() {
	const blob = new Blob([JSON.stringify(Context.serialize())], {
		type: "application/json",
	});
	const a = document.createElement("a");
	a.href = URL.createObjectURL(blob);
	a.download = "graph.json";
	a.click();
	URL.revokeObjectURL(a.href);
}

function loadGraphFromFile() {
	const input = document.createElement("input");
	input.type = "file";
	input.accept = ".json";
	input.addEventListener("change", async () => {
		const file = input.files[0];
		if (file) await Context.deserialize(JSON.parse(await file.text()));
	});
	input.click();
}

async function initToolbar() {
	const bar = document.getElementById("toolbar");
	const btn = (label, cb) => {
		const b = document.createElement("button");
		b.textContent = label;
		b.addEventListener("click", cb);
		bar.append(b);
		return b;
	};
	btn("Save", saveGraph);
	btn("Save to server", async () => {
		const name = await modalInput("graph name");
		if (!name) return;
		const resp = await fetch(`save_graph/${name}`, {
			method: "POST",
			body: JSON.stringify(Context.serialize()),
		});
		if (!resp.ok) alert(await resp.text());
	});
	btn("Load file", loadGraphFromFile);

	const sel = document.createElement("select");
	sel.title = "server graph library";
	const opt0 = document.createElement("option");
	opt0.textContent = "Load graph…";
	opt0.value = "";
	sel.append(opt0);
	try {
		for (const name of await (await fetch("list_graphs")).json()) {
			const o = document.createElement("option");
			o.value = name;
			o.textContent = name;
			sel.append(o);
		}
	} catch (e) {
		console.warn("list_graphs failed", e);
	}
	sel.addEventListener("change", async () => {
		if (sel.value) await loadGraphByName(sel.value);
		sel.value = "";
	});
	bar.append(sel);

	const metrics = document.createElement("span");
	metrics.id = "metrics";
	bar.append(metrics);
	setInterval(async () => {
		try {
			const m = await (await fetch("metrics")).json();
			metrics.textContent =
				`p50 ${m.request_p50_ms.toFixed(0)}ms · ` +
				`${m.counters.compute_requests ?? 0} reqs · ` +
				`batch x${(m.mean_batch_size ?? 1).toFixed(1)}`;
		} catch {}
	}, 5000);
}

async function initTools() {
	const spawn = (kind) => async (x, y) => {
		const node = await Context.createNode(kind);
		if (node) node_move(node, x, y);
	};
	for (const kind of [
		"img_src", "img_view", "multi_view", "attn_view", "overlay", "slice",
		"shuffle", "binop", "const", "noise", "conv2d", "resize", "cos",
	]) {
		Workspace.registerTool(kind, spawn(kind));
	}
	// server-side-only nodes (pure net nodes): PCA-to-RGB and
	// token-similarity heatmap (DINO-style views), zero-shot similarity
	// join (CLIP image x text embeddings), input-gradient saliency
	// (jax.grad through the staged program — inherently server-side),
	// occlusion sensitivity (a lax.scan of masked forwards)
	for (const endpoint of ["pca_view", "patch_sim", "similarity", "saliency", "dream", "occlusion"]) {
		Workspace.registerTool(endpoint, async (x, y) => {
			try {
				const node = Context.addNodeInstance(await NetNode.create(endpoint));
				node_move(node, x, y);
			} catch (e) {
				alert(`server node unavailable: ${e}`);
			}
		});
	}
	// spawn any served model layer by endpoint name (full model chains come
	// from the graph library dropdown)
	Workspace.registerTool("layer…", async (x, y) => {
		const endpoint = await modalInput(
			"server node endpoint", "e.g. vit_t16:blocks.0");
		if (!endpoint) return;
		try {
			const node = Context.addNodeInstance(await NetNode.create(endpoint));
			node_move(node, x, y);
		} catch (e) {
			alert(`unknown endpoint: ${e}`);
		}
	});
}

async function main() {
	Context.container = document.getElementById("nodes");
	Context.svg = document.getElementById("edges");
	Context.onChange = scheduleEval;
	registerAll();
	Workspace.init(document.getElementById("workspace"));
	await initTools();
	await initToolbar();

	// graph-edit keys: undo/redo, delete selection (skip while typing)
	window.addEventListener("keydown", async (ev) => {
		const tag = ev.target?.tagName;
		if (tag === "INPUT" || tag === "TEXTAREA" || tag === "SELECT") return;
		if ((ev.ctrlKey || ev.metaKey) && ev.key.toLowerCase() === "z") {
			ev.preventDefault();
			await (ev.shiftKey ? Context.redo() : Context.undo());
		} else if ((ev.ctrlKey || ev.metaKey) && ev.key.toLowerCase() === "y") {
			ev.preventDefault();
			await Context.redo();
		} else if (ev.key === "Delete" || ev.key === "Backspace") {
			ev.preventDefault();
			Context.removeSelected();
		}
	});
}

main();
