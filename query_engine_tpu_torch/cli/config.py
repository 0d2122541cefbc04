"""CLI configuration + table registry.

Parity surface: reference crates/query-cli/src/config.rs:5-43 — a JSON
config file with show_timing / show_plan / max_rows / output_format, plus
the `register` subcommand's persisted table map.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict

DEFAULT_PATH = os.path.expanduser("~/.qe_tpu.json")


@dataclass
class CliConfig:
    show_timing: bool = False
    show_plan: bool = False
    max_rows: int = 100
    output_format: str = "table"  # table | csv | json
    tables: Dict[str, str] = field(default_factory=dict)  # name -> csv path

    @staticmethod
    def load(path: str = DEFAULT_PATH) -> "CliConfig":
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                return CliConfig(**{
                    k: v for k, v in data.items()
                    if k in CliConfig.__dataclass_fields__
                })
            except (json.JSONDecodeError, TypeError):
                pass
        return CliConfig()

    def save(self, path: str = DEFAULT_PATH) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)
