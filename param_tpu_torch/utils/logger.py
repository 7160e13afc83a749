"""Result records and sinks of the compute and comms tiers (the port's own
copy of what it uses of ``param_tpu/utils/logger.py``).

A bench builds a :class:`ComputePerfMetrics`, :class:`CommsCollPerfMetrics`
(with a :class:`CommsQuantCollPerfMetrics` for a quantized row) or
:class:`CommsPt2PtPerfMetrics` per result and hands it to
:func:`emit_metrics`, which passes it to every registered sink (none by
default): :class:`StdoutJsonLogger` prints one JSON line,
:class:`FileJsonLogger` appends one to a file.  :func:`setup_rank_logging`
tags log records with the rank; :func:`graceful_exit` logs and exits.
"""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


@dataclass
class CommsPerfMetrics:
    """Base record for a communication benchmark result."""

    commsOp: str
    dtype: str
    backend: str = "dist"
    world_size: int = 1
    tag: str = ""


@dataclass
class CommsQuantCollPerfMetrics(CommsPerfMetrics):
    """A quantized collective's extras: ``quant_us`` is one quantize and
    dequantize of the message without communication."""

    bitwidth: int = 32
    quant_us: float = 0.0
    dequant_us: float = 0.0


@dataclass
class CommsCollPerfMetrics(CommsPerfMetrics):
    """One row of a collective sweep."""

    input_size_bytes: int = 0
    output_size_bytes: int = 0
    num_elements: int = 0
    p50_us: float = 0.0
    p75_us: float = 0.0
    p95_us: float = 0.0
    min_us: float = 0.0
    max_us: float = 0.0
    alg_bw_gbs: float = 0.0
    bus_bw_gbs: float = 0.0
    quant: Optional[CommsQuantCollPerfMetrics] = None


@dataclass
class CommsPt2PtPerfMetrics(CommsPerfMetrics):
    """pt2pt result record."""

    input_size_bytes: int = 0
    ping_p50_us: float = 0.0
    ping_pong_p50_us: float = 0.0
    uni_bw_gbs: float = 0.0
    bi_bw_gbs: float = 0.0


@dataclass
class ComputePerfMetrics:
    """Compute-tier result record (GEMM / embedding / MLP)."""

    op: str
    dtype: str
    shape: List[int] = field(default_factory=list)
    lat_us: float = 0.0
    tflops: float = 0.0
    gbs: float = 0.0
    roofline_frac: float = 0.0


class PerfLogger(ABC):
    """Sink interface."""

    @abstractmethod
    def log_metrics(self, metrics) -> None: ...


def _line(metrics) -> str:
    return json.dumps({"type": type(metrics).__name__, **asdict(metrics)})


class StdoutJsonLogger(PerfLogger):
    def log_metrics(self, metrics) -> None:
        print(_line(metrics))


class FileJsonLogger(PerfLogger):
    def __init__(self, path: str):
        self.path = path

    def log_metrics(self, metrics) -> None:
        with open(self.path, "a") as f:
            f.write(_line(metrics) + "\n")


_PERF_LOGGERS: Dict[str, PerfLogger] = {}


def register_perf_logger(name: str, logger: PerfLogger) -> None:
    if name in _PERF_LOGGERS:
        log.warning("perf logger %s already registered; overwriting", name)
    _PERF_LOGGERS[name] = logger


def unregister_perf_logger(name: str) -> None:
    _PERF_LOGGERS.pop(name, None)


def get_perf_loggers() -> List[PerfLogger]:
    return list(_PERF_LOGGERS.values())


def emit_metrics(metrics) -> None:
    """Hand ``metrics`` to every registered sink; a sink that fails is
    logged and the others still run."""
    for lg in _PERF_LOGGERS.values():
        try:
            lg.log_metrics(metrics)
        except Exception:  # noqa: BLE001 — a bad sink must not kill the bench
            log.exception("perf logger failed")


def setup_rank_logging(rank: int = 0, level: str = "INFO") -> None:
    """Log records tagged with the rank, at ``level``, replacing the root
    logger's handlers."""
    logging.basicConfig(
        level=level.upper(),
        format=f"[%(asctime)s][rank {rank}][%(levelname)s] "
               "%(name)s: %(message)s",
        force=True,
    )


def graceful_exit(msg: str = "", code: int = 1):
    """Log ``msg`` as an error (when given) and raise ``SystemExit(code)``."""
    if msg:
        log.error(msg)
    raise SystemExit(code)
