"""Node-kind registry and plugin loader.

Preserves the plugin contract of the reference
(``/root/reference/main/context.py:16-36,132-176``): a process-global registry
of named ``NodeKind``s, each answering ``io(params)`` / ``contents(params)`` /
``compute(params, pinin)``, discovered by importing every ``.py`` file in the
plugin dirs and calling its module-level ``instances()``.

Design change: a node kind's compute is primarily exposed as a **pure,
traceable function** (``NodeKind.fn``) from a dict of input arrays to a dict
of output arrays. The staging executor composes those functions into one
jitted XLA program; the eager ``compute`` path (used for per-node debugging
and error attribution) is derived from the same function, so the two paths
cannot drift.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import sys
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import urlencode

from interactive_vit_tpu.graph.ir import Graph, Pinout

logger = logging.getLogger(__name__)

# A staged node computation: dict[channel -> array] -> dict[channel -> array].
NodeFn = Callable[[Dict[str, Any]], Dict[str, Any]]


class NodeKind:
    """Base class for a registered node kind.

    Contract parity with ``main/context.py:16-36``. Subclasses implement
    ``fn(params)`` (preferred, traceable) or override ``compute`` directly
    for host-side nodes that cannot be traced.
    """

    # Gradient node kinds (e.g. ops.node_ops.SaliencyNode) set this True
    # and implement ``grad_fn(params) -> run(forward, x, caps)`` plus
    # ``grad_wrt(params) -> ("input", k) | ("node", idx, ch)``: the
    # staged executor hands them their ancestor cone as a closed function
    # ``forward`` of the chosen leaf — graph input k, or an upstream
    # node's output channel (the Grad-CAM case) — so they can jax.grad
    # through the upstream graph inside the same jitted program.
    # Ordinary kinds never see this.
    grad_node = False

    # Grad-node kinds that never differentiate their replay (forward-only
    # attribution, e.g. ops.node_ops.OcclusionNode) set this False: the
    # executor then re-traces the replayed cone through each kind's
    # regular ``fn`` (possibly kernel-backed) instead of its grad twin.
    differentiates = True

    def __init__(self, name: str):
        self.name = name

    def get_name(self) -> str:
        return self.name

    def contents(self, params: Dict[str, str]) -> str:
        """HTML body shown inside the node's box in the UI."""
        return self.name + "?" + urlencode(params)

    def io(self, params: Dict[str, str]) -> Dict[str, List[str]]:
        """Declare input/output channel names: ``{"ins": [...], "outs": [...]}``."""
        raise NotImplementedError(f"io() not implemented for {self.name}")

    def extra_outs(self, params: Dict[str, str]) -> List[str]:
        """Expensive OPTIONAL output channels (e.g. attention maps).

        The "primary" tap policy (the serving default) returns every output
        EXCEPT unconsumed extras — the reference's return-everything contract
        covered only primary channels (its nodes had a single "o",
        ``context.py:94-96``); extras are this framework's extension and are
        computed only when wired or explicitly tapped.
        """
        return []

    def fn(self, params: Dict[str, str]) -> NodeFn:
        """Return a pure function computing this node (jax-traceable).

        If ``captures(params)`` returns non-None, the function signature is
        ``fn(ins, caps)`` instead of ``fn(ins)`` — the executor hoists the
        captured pytree (typically model weights) into a jit *argument* so
        multi-hundred-MB weights are device-resident buffers, not HLO
        constants.
        """
        raise NotImplementedError(f"fn() not implemented for {self.name}")

    def grad_safe_fn(self, params: Dict[str, str]) -> NodeFn:
        """``fn`` variant used when the node is re-traced INSIDE a
        gradient replay (``jax.grad`` of a downstream saliency/dream
        node flows through it). Kinds whose ``fn`` is not differentiable
        — Pallas custom calls have no AD rule, activation-quantized
        matmuls have zero gradient a.e. — override this with an XLA
        twin (``models/model_plugin.JaxModel(grad_layers=...)``)."""
        return self.fn(params)

    def captures(self, params: Dict[str, str]):
        """Large arrays (weights) to pass as jit args; None for stateless ops."""
        return None

    def dynamic_sig(self, params: Dict[str, str]) -> Optional[str]:
        """Shape-class key for the dynamic params, or None.

        dynamic_params removes VALUES from the compile signature; when a
        dynamic param ALSO determines capture shapes in a coarser way
        (e.g. the prompt node's token array is [n_prompts, 77] — wording
        is dynamic, COUNT changes shapes), return a string capturing
        exactly the shape-determining part so different shapes never
        share a cached program."""
        return None

    def param_variants(self, params: Dict[str, str]) -> List[Dict[str, str]]:
        """Neighbor param sets the speculative warmer should precompile.

        Return param dicts the user is LIKELY to produce next when the
        edit changes the compile signature (e.g. the prompt node yields
        count+1 / count-1 prompt lists — rewording is already dynamic,
        but add/remove recompiles). Default: none."""
        return []

    def dynamic_capture_keys(self) -> Optional[frozenset]:
        """The subset of capture dict keys whose values depend on the
        dynamic params; None = all of them (the default).

        The micro-batcher stacks dynamic captures per request (vmap
        in_axes 0) — a node whose capture dict mixes big static weights
        with small dynamic values (the prompt node: embed table +
        tokens) must name the dynamic keys so the weights broadcast
        instead of stacking k copies."""
        return None

    def dynamic_params(self) -> frozenset:
        """Param names whose VALUES ride as runtime captures, not trace
        constants: they are excluded from the compile-cache signature and
        refreshed from the graph on every run, so interactively editing
        them (cos A/b, noise seed, the conv matrix, patch_sim's query)
        re-keys the cached program instead of recompiling the whole
        graph. A kind declaring these MUST deliver the values via
        ``captures()`` with a stable structure/shape/dtype."""
        return frozenset()

    def compute(self, params: Dict[str, str], inputs: Pinout) -> Pinout:
        """Eager evaluation — default implementation calls ``fn``."""
        caps = self.captures(params)
        if caps is None:
            out = self.fn(params)(inputs.as_dict())
        else:
            out = self.fn(params)(inputs.as_dict(), caps)
        return Pinout(out)

    def register(self, reg: "Registry") -> None:
        reg.register(self)


class Registry:
    """Process-global registry of node kinds (``main/context.py:132-152``)."""

    def __init__(self) -> None:
        self.nodes: Dict[str, NodeKind] = {}

    def register(self, node: NodeKind) -> None:
        name = node.get_name()
        if name in self.nodes and self.nodes[name] is not node:
            # loud, because silent replacement has teeth: a plugin scan
            # ordered after explicit model registration would swap a
            # checkpoint-loaded kind for a random-init one
            logger.warning("node kind %r replaced (was %r)", name,
                           type(self.nodes[name]).__name__)
        logger.info("registered node kind: %s", name)
        self.nodes[name] = node

    def get_node(self, name: str) -> NodeKind:
        if name not in self.nodes:
            raise KeyError(f"unknown node kind: {name!r}")
        return self.nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def names(self) -> List[str]:
        return sorted(self.nodes)

    def compute(self, graph: Graph) -> None:
        """Eager per-node evaluation (debug path).

        Matches the reference hot loop (``context.py:143-147``). Production
        evaluation goes through ``executor.Executor`` which stages the whole
        graph into one XLA program instead.
        """
        from interactive_vit_tpu.graph.ir import effective_params

        for n in graph.order():
            kind = self.get_node(n.name)
            pinout = kind.compute(effective_params(n), n.get_pinin())
            n.set_pinout(pinout)


_instance = Registry()


def registry() -> Registry:
    """The process-global registry (``context.py:149-152``)."""
    return _instance


def scan_plugins(dirs: List[str], reg: Optional[Registry] = None) -> None:
    """Import every ``.py`` in ``dirs``; call its ``instances()``; register.

    Failures are logged and skipped, never fatal — parity with
    ``context.py:154-176`` (which deliberately survives the broken
    ``main/nodes/conv.py`` plugin).
    """
    reg = reg or registry()
    for full_dir in dirs:
        if not os.path.isdir(full_dir):
            logger.warning("plugin dir missing: %s", full_dir)
            continue
        for file in sorted(os.listdir(full_dir)):
            path = os.path.join(full_dir, file)
            if not os.path.isfile(path) or not path.endswith(".py"):
                continue
            # namespaced module name: a plugin file called queue.py/json.py
            # must NOT hijack sys.modules['queue'] for the whole process
            name = "ivt_plugins." + os.path.splitext(file)[0]
            try:
                spec = importlib.util.spec_from_file_location(name, path)
                assert spec is not None and spec.loader is not None
                module = importlib.util.module_from_spec(spec)
                sys.modules[name] = module
                try:
                    spec.loader.exec_module(module)
                except Exception:
                    sys.modules.pop(name, None)  # no half-initialized leftovers
                    raise
                for inst in module.instances():
                    inst.register(reg)
            except Exception as err:  # noqa: BLE001 — plugin isolation by design
                logger.info("could not register plugin %s: %s", path, err)
