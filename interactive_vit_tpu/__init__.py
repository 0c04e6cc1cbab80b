"""interactive_vit_tpu — an interactive tappable-graph framework on JAX.

A ground-up rebuild of the capabilities of the reference app
``0Marble/interactive-vit`` (an interactive dataflow-graph visualizer whose
compute core ran torch CPU submodules one at a time,
the reference's ``main/context.py:143-147``), re-designed for an
accelerator:

* the graph executor stages an entire graph into ONE jitted XLA program with
  the *tapped* edges as explicit outputs (``graph/executor.py``) instead of an
  eager per-node loop;
* hot ops keep a plain jnp path that XLA compiles everywhere; attention
  with map taps has a Pallas-Triton GPU kernel and maps-off attention
  calls cuDNN (``ops/dispatch.py``);
* models (ViT family, CLIP image encoder) are functional pytree programs whose
  every block is a tappable graph node (``models/``);
* scaling is expressed as ``jax.sharding.Mesh`` + sharding constraints so XLA
  inserts the collectives (``parallel/``);
* the serving layer micro-batches concurrent interactive requests into
  device batches (``serving/``), speaking the reference's binary wire protocol
  (``wire/``, magics 0x69babe69 / 0xdeadbeef preserved byte-for-byte).
"""

__version__ = "0.1.0"

from interactive_vit_tpu.graph.ir import Graph, Node, Port, Edge, Pinout  # noqa: F401
from interactive_vit_tpu.graph.registry import NodeKind, Registry, registry  # noqa: F401
from interactive_vit_tpu.graph.executor import Executor, NodeError  # noqa: F401
