"""Dtype name map for the port's CLIs (torch counterpart of
``param_tpu/utils/dtypes.py``)."""

from __future__ import annotations

import torch

DTYPE_MAP = {
    "float32": torch.float32,
    "float": torch.float32,
    "float16": torch.float16,
    "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "double": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int": torch.int32,
    "int64": torch.int64,
    "long": torch.int64,
    "bool": torch.bool,
    "byte": torch.uint8,
    "char": torch.int8,
    "float8_e4m3": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}

# dtypes a reduction collective (all_reduce / reduce / reduce_scatter) takes
REDUCE_DTYPES = {
    "float32",
    "float",
    "float16",
    "half",
    "bfloat16",
    "float64",
    "double",
    "int8",
    "int16",
    "int32",
    "int",
    "int64",
    "long",
}


def dtype_from_name(name: str) -> torch.dtype:
    try:
        return DTYPE_MAP[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; supported: {sorted(DTYPE_MAP)}"
        ) from None


def dtype_size(dtype: torch.dtype) -> int:
    """Element size in bytes."""
    return torch.empty((), dtype=dtype).element_size()
