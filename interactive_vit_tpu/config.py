"""Framework configuration: one flat dataclass, env-var overridable.

SURVEY.md §5: the reference's only config was Django settings plus
stringly-typed per-node params. The node-param contract is preserved on the
wire (``graph/ir.py``); framework-level knobs live here, every field
overridable via ``IVT_<UPPERCASE_NAME>`` so deployments configure the server
without code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default, cast):
    raw = os.environ.get(f"IVT_{name.upper()}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes")
    return cast(raw)


@dataclasses.dataclass
class Config:
    # serving
    host: str = "127.0.0.1"
    port: int = 8000
    max_batch: int = 8
    max_wait_ms: float = 3.0
    models: str = "vit_t16"
    graphs_dir: Optional[str] = None
    frontend_dir: Optional[str] = None
    compute_timeout_s: float = 120.0  # /compute deadline; wedged device -> 503

    # compute
    attn_impl: str = "auto"          # auto | reference (ops/dispatch)
    compute_dtype: str = "bfloat16"  # serving compute dtype
    use_jit: bool = True

    # observability
    profiler_port: int = 0           # 0 = off
    debug_nans: bool = False
    log_level: str = "INFO"

    # native tier
    native: bool = True              # C++ codec fast path

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            setattr(cfg, f.name, _env(f.name, getattr(cfg, f.name),
                                      type(getattr(cfg, f.name))
                                      if getattr(cfg, f.name) is not None
                                      else str))
        return cfg
