"""Per-column sorted value dictionaries (copy of
``pinot_tpu.segment.dictionary``, trimmed).

Values are stored sorted, ``index_of`` is a binary search, and dictIds
are therefore *order-preserving* — which is what lets range predicates
become dictId-space comparisons on the device
(``ImmutableDictionaryReader.java:25`` in the reference).
"""
from __future__ import annotations

import bisect
from typing import Any, List, Sequence, Union

import numpy as np

from pinot_tpu_torch.common.schema import DataType


class Dictionary:
    """Sorted, deduplicated value dictionary for one column."""

    def __init__(self, stored_type: DataType, values: Union[np.ndarray, List[str]]):
        self.stored_type = stored_type
        self.is_string = stored_type == DataType.STRING
        if self.is_string:
            self.values: Union[np.ndarray, List[str]] = list(values)
            self._np = np.asarray(self.values, dtype=object)
        else:
            self.values = np.asarray(values, dtype=stored_type.to_numpy())
            self._np = self.values

    @classmethod
    def build(cls, stored_type: DataType, raw_values: Sequence[Any]) -> "Dictionary":
        """The sorted, deduplicated dictionary of a column's raw values."""
        if stored_type == DataType.STRING:
            return cls(stored_type, sorted(set(str(v) for v in raw_values)))
        arr = np.asarray(list(raw_values), dtype=stored_type.to_numpy())
        return cls(stored_type, np.unique(arr))

    def __len__(self) -> int:
        return len(self.values)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def value_array(self) -> np.ndarray:
        """Values as one reusable numpy array (object dtype for strings),
        for vectorized gathers on the distinct-partial paths."""
        return self._np

    def get(self, dict_id: int) -> Any:
        v = self.values[dict_id]
        if self.is_string:
            return v
        return v.item()

    def index_of(self, value: Any) -> int:
        """dictId of value, or -1 if absent."""
        i = self.insertion_index(value)
        if 0 <= i < len(self.values) and self._eq(self.values[i], value):
            return int(i)
        return -1

    def insertion_index(self, value: Any) -> int:
        """Index of the first element >= value (np.searchsorted 'left')."""
        if self.is_string:
            return bisect.bisect_left(self.values, str(value))
        return int(np.searchsorted(self.values, value, side="left"))

    def _eq(self, a: Any, b: Any) -> bool:
        if self.is_string:
            return a == str(b)
        return bool(a == b)

    def index_array(self, raw: np.ndarray) -> np.ndarray:
        """Vectorized ``index_of`` for building forward indexes (every
        value must be present)."""
        if self.is_string:
            lookup = {v: i for i, v in enumerate(self.values)}
            return np.fromiter((lookup[v] for v in raw), dtype=np.int32, count=len(raw))
        return np.searchsorted(self.values, raw).astype(np.int32)

    @property
    def min_value(self) -> Any:
        return self.get(0) if len(self.values) else None

    @property
    def max_value(self) -> Any:
        return self.get(len(self.values) - 1) if len(self.values) else None
