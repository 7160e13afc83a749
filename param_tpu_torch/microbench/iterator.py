"""Config iterators: expand ``__range__`` / ``__copy__`` macros (the port's
own copy of ``param_tpu/microbench/iterator.py``, pure Python).

Counterpart of the reference's ``lib/iterator.py`` —
``DefaultConfigIterator`` (:241), ``RangeConfigIterator`` (:176) and the
registry (:281-293).  Semantics documented in the reference's
development.md:90-160:

- ``"__range__": ["shape"]`` — elements of the named attribute that are
  ``[min, max, step]`` lists (or lists of choices for non-numeric values)
  expand into the cartesian product.
- ``"__copy__": [{"shape": [i, [j, k]]}]`` — after range expansion, element
  ``i`` of this arg's attribute is overwritten with element ``k`` of
  argument ``j``'s same attribute (tensor args only).
"""

from __future__ import annotations

import copy
from abc import ABC, abstractmethod
from typing import Any, Dict, Iterator, List, Type

from param_tpu_torch.microbench.generator import IterableList, ListProduct, TableProduct


def _expand_attr(value):
    """Expand one __range__-marked attribute value into an iterable."""
    if isinstance(value, list) and value and all(
        not isinstance(v, (list, dict)) for v in value
    ) and not all(isinstance(v, (int, float)) for v in value):
        # list of non-numeric choices (bool/str)
        return IterableList(value)
    if isinstance(value, list):
        # a shape-like list: elements that are [min, max, step] expand
        items = []
        for v in value:
            if isinstance(v, list):
                if len(v) != 3:
                    raise ValueError(f"range element must be [min,max,step]: {v}")
                lo, hi, step = v
                items.append(IterableList(list(range(lo, hi + 1, step))))
            else:
                items.append(v)
        return ListProduct(items)
    raise ValueError(f"cannot __range__-expand attribute value {value!r}")


def _scalar_range(value):
    """__range__ on a scalar attribute whose value is a list of choices."""
    return IterableList(list(value))


def expand_arg(arg: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """Yield concrete versions of one arg spec (applying __range__)."""
    rng = arg.get("__range__", [])
    if not rng:
        yield {k: v for k, v in arg.items() if not k.startswith("__")} | {
            k: v for k, v in arg.items() if k == "__copy__"
        }
        return
    table: Dict[str, Any] = {}
    for k, v in arg.items():
        if k.startswith("__"):
            continue
        if k in rng:
            if k == "shape" or (isinstance(v, list) and any(
                isinstance(e, list) for e in v
            )):
                table[k] = _expand_attr(v)
            else:
                table[k] = _scalar_range(v)
        else:
            table[k] = v
    for concrete in TableProduct(table):
        out = dict(concrete)
        if "__copy__" in arg:
            out["__copy__"] = arg["__copy__"]
        yield out


def apply_copy(args: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Apply __copy__ macros across a positional arg list
    (reference: development.md __copy__ spec)."""
    out = [dict(a) for a in args]
    for arg in out:
        for rule in arg.pop("__copy__", []):
            for attr, (i, (j, k)) in (
                (a, (r[0], tuple(r[1]))) for a, r in rule.items()
            ):
                src = out[j][attr]
                arg[attr] = list(arg[attr])
                arg[attr][i] = src[k]
    return out


def _expand_args_list(args: List[Dict[str, Any]]) -> Iterator[List[Dict]]:
    for combo in ListProduct([IterableList(list(expand_arg(a))) for a in args]):
        yield apply_copy([copy.deepcopy(c) for c in combo])


class ConfigIterator(ABC):
    """(reference: lib/iterator.py ConfigIterator interface)"""

    def __init__(self, configs: List[Dict[str, Any]], key: str = "input"):
        self.configs = configs
        self.key = key

    @abstractmethod
    def __iter__(self) -> Iterator[Dict[str, Any]]: ...


class DefaultConfigIterator(ConfigIterator):
    """Each config entry yields exactly one materialized config (applying
    __copy__ but no range expansion) — reference DefaultConfigIterator:241."""

    def __iter__(self):
        for cfg in self.configs:
            for entry in cfg.get(self.key, []):
                args = apply_copy([
                    {k: v for k, v in a.items() if k != "__range__"}
                    for a in entry.get("args", [])
                ])
                yield {"args": args, "kwargs": entry.get("kwargs", {})}


class RangeConfigIterator(ConfigIterator):
    """Expands every __range__ macro into the cartesian product —
    reference RangeConfigIterator:176."""

    def __iter__(self):
        for cfg in self.configs:
            for entry in cfg.get(self.key, []):
                for args in _expand_args_list(entry.get("args", [])):
                    yield {"args": args, "kwargs": entry.get("kwargs", {})}


_ITERATORS: Dict[str, Type[ConfigIterator]] = {}


def register_config_iterator(name: str, cls: Type[ConfigIterator]) -> None:
    """(reference: lib/iterator.py:281-293)"""
    _ITERATORS[name] = cls


def get_config_iterator(name: str) -> Type[ConfigIterator]:
    return _ITERATORS[name]


register_config_iterator("DefaultConfigIterator", DefaultConfigIterator)
register_config_iterator("RangeConfigIterator", RangeConfigIterator)
