"""query_engine_tpu_torch — the SQL engine on PyTorch and CUDA.

The PyTorch port of `query_engine_tpu`. It keeps the JAX package's layout
and module names so each module's counterpart is easy to find, and it
imports neither `jax` nor `query_engine_tpu`.

Layer map:
  core/       types, schema, errors, UDF registry, endpoint config (copied)
  columnar/   ColumnBatch: torch data + validity planes on one device, host
              dictionaries for strings; convert.py takes planes from numpy
  sql/        lexer, AST, recursive-descent parser (copied)
  plan/       logical plan, planner, optimizer, physical plan (copied)
  ops/        kernels.py (plain torch), group_agg.py (the hand-written CUDA
              grouped SUM/COUNT kernel in csrc/group_agg.cu),
              small_gather.py, agg_variants.py (the one-hot tensor-core
              aggregate kernels), _build.py
  engine/     expression evaluator, eager executor, Session
  probes/     the aggregate probes, counterparts of benchmarks/probe_*.py
  storage/    in-memory, CSV and Parquet sources (copied; pyarrow is
              imported only when a CSV or Parquet table is registered)
  index/      B-Tree and Hash indexes + manager (copied)

Devices: every tensor the engine makes lives on the device passed to
`Session(device=...)`, the card ("cuda") by default; `device="cpu"` asks
for the CPU. Without CUDA, `Session()` raises; nothing falls back to the
CPU.
"""

__version__ = "0.1.0"

from query_engine_tpu_torch.core.errors import QueryError  # noqa: E402
from query_engine_tpu_torch.core.types import DataType  # noqa: E402
from query_engine_tpu_torch.core.schema import Field, Schema  # noqa: E402

__all__ = ["QueryError", "DataType", "Field", "Schema", "__version__"]
