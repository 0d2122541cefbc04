"""Scalar UDF trait + case-insensitive registry.

Parity surface: reference crates/query-core/src/udf.rs:13-108
(`ScalarUdf::{name,signature,invoke}`, `UdfSignature`, `UdfRegistry`).

A UDF's `invoke` receives whole device columns (tensors plus validity
masks) and returns a (data, validity) pair, so UDFs vectorize like built-in
scalar functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.types import DataType


@dataclass(frozen=True)
class UdfSignature:
    """Input types -> return type (reference udf.rs:20-34)."""

    input_types: Tuple[DataType, ...]
    return_type: DataType
    variadic: bool = False

    def arity_ok(self, n: int) -> bool:
        if self.variadic:
            return n >= len(self.input_types)
        return n == len(self.input_types)


class ScalarUdf:
    """A scalar UDF over whole columns.

    Subclass or construct with a callable:
        f(args: list[(data, validity)]) -> (data, validity)
    """

    def __init__(
        self,
        name: str,
        signature: UdfSignature,
        fn: Callable[[Sequence[Tuple]], Tuple],
    ):
        self._name = name
        self._signature = signature
        self._fn = fn

    @property
    def name(self) -> str:
        return self._name

    @property
    def signature(self) -> UdfSignature:
        return self._signature

    def invoke(self, args: Sequence[Tuple]) -> Tuple:
        if not self._signature.arity_ok(len(args)):
            raise ExecutionError(
                f"UDF {self._name} expects {len(self._signature.input_types)} "
                f"args, got {len(args)}"
            )
        return self._fn(args)


class UdfRegistry:
    """Case-insensitive UDF registry (reference udf.rs:66-108)."""

    def __init__(self):
        self._udfs: Dict[str, ScalarUdf] = {}

    def register(self, udf: ScalarUdf) -> None:
        self._udfs[udf.name.lower()] = udf

    def get(self, name: str) -> Optional[ScalarUdf]:
        return self._udfs.get(name.lower())

    def contains(self, name: str) -> bool:
        return name.lower() in self._udfs

    def names(self) -> List[str]:
        return sorted(self._udfs)

    def deregister(self, name: str) -> None:
        self._udfs.pop(name.lower(), None)
