"""Generic cartesian iteration primitives (the port's own copy of
``param_tpu/microbench/generator.py``, pure Python).

Counterpart of the reference's ``lib/generator.py:4-158`` (``full_range``,
``IterableList``, ``ListProduct``, ``TableProduct``) — the building blocks
the config iterators expand macros with.  Semantics: nested products
iterate like an odometer; non-iterable values pass through unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List


def full_range(start: int, end: int, step: int = 1) -> Iterator[int]:
    """Inclusive range [start, end] (the reference's range semantics for
    [min, max, step] shape specs)."""
    cur = start
    while cur <= end:
        yield cur
        cur += step


class IterableList:
    """Marks a plain list of choices as iterable (vs a literal list value)."""

    def __init__(self, items: List[Any]):
        self.items = list(items)

    def __iter__(self):
        return iter(self.items)


def _is_iter(v) -> bool:
    return isinstance(v, (IterableList, ListProduct, TableProduct)) or (
        hasattr(v, "__next__")
    )


class ListProduct:
    """Cartesian product over the iterable elements of a list; literal
    elements are repeated in every output."""

    def __init__(self, items: List[Any]):
        self.items = items

    def __iter__(self) -> Iterator[List[Any]]:
        return self._gen(self.items)

    @staticmethod
    def _gen(items: List[Any]) -> Iterator[List[Any]]:
        if not items:
            yield []
            return
        head, rest = items[0], items[1:]
        if isinstance(head, (IterableList, ListProduct, TableProduct)):
            for h in head:
                for r in ListProduct._gen(rest):
                    yield [h] + r
        else:
            for r in ListProduct._gen(rest):
                yield [head] + r


class TableProduct:
    """Cartesian product over the iterable values of a dict."""

    def __init__(self, table: Dict[str, Any]):
        self.table = table

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        keys = list(self.table.keys())
        return self._gen(keys, self.table)

    @staticmethod
    def _gen(keys, table) -> Iterator[Dict[str, Any]]:
        if not keys:
            yield {}
            return
        head, rest = keys[0], keys[1:]
        val = table[head]
        if isinstance(val, (IterableList, ListProduct, TableProduct)):
            for v in val:
                for r in TableProduct._gen(rest, table):
                    yield {head: v, **r}
        else:
            for r in TableProduct._gen(rest, table):
                yield {head: val, **r}
