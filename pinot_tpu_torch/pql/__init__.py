"""PQL parser and broker-side optimizer (copies of pinot_tpu.pql)."""
from pinot_tpu_torch.pql.optimizer import optimize_request
from pinot_tpu_torch.pql.parser import PqlParseError, parse_pql

__all__ = ["parse_pql", "PqlParseError", "optimize_request"]
