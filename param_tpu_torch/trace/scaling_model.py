"""Analytic scaling model: predict collective and trace times at world
sizes a run cannot reach (the port's ``param_tpu/trace/scaling_model.py``,
with the NVIDIA H100 in place of the JAX package's generation table).

PARAM traces exist to answer platform questions: what would this
workload's communication cost at scale?  PARAM runs on real clusters or
hands its Chakra traces to simulators.  This module gives a first-order
closed-form answer: a latency-bandwidth model of the collectives, applied
per op to a parsed comm trace across a sweep of world sizes.

PARAM's analogues: the analytic matmul time model used for autotune
pruning (``train/comms/pt/matmul_perf_model.py:71``, the same max / sum of
latency and bandwidth terms) and the busBW correction tables
(``pytorch_backend_utils.py:200-247``), whose (n-1)/n geometry the ring
rows reproduce: in the large-message limit the predicted busBW of every
ring collective equals the per-GPU wire rate ``W``, as nccl-tests defines
busBW.

Topology.  One node is 8 H100 GPUs on NVSwitch.  The node is modelled as a
ring of its GPUs with both directions (``link_gbs`` 225 GB/s one way a
direction, so ``W`` = 450 GB/s, the GPU's 18 NVLink-4 links at 25 GB/s one
way); any subset of a node's GPUs is such a ring, since the switch
connects every pair.  Worlds larger than a node are whole nodes joined by
the inter-node network (``dcn_gbs_per_host``: one 400 Gb/s NIC a GPU, 50
GB/s one way each, 400 a node).  ``B`` is the per-rank payload in bytes,
the figure the sweep calls ``size``.

====================  ==================================================
collective            time (bandwidth term, in a node)
====================  ==================================================
all_gather            B.(n-1)/n / W            (bidirectional ring)
reduce_scatter        B.(n-1)/n / W
all_reduce            2.B.(n-1)/n / W          (reduce_scatter + all_gather)
broadcast / reduce    B.(n-1)/n / W            (pipelined ring)
gather / scatter      B.(n-1) / W              (the root's links bound it)
all_to_all            B.(n-1)/n / W            (switch: see below)
pt2pt                 B / W + one step          (switch: see below)
====================  ==================================================

The two switch rows are this model's own, not the JAX package's torus
rows.  On a torus an all_to_all ships B bytes a mean distance that grows
with the axis, and a point-to-point transfer crosses several hops at one
link's rate.  Through NVSwitch every pair is one hop apart at the GPU's
full NVLink rate: each GPU sends its (n-1)/n of B to the others and
receives as much, so an all_to_all costs what an all_gather costs, and a
point-to-point transfer moves B at W.

Each collective adds a latency term of ``steps x hop_latency_us`` (a ring
takes n - 1 steps).  Worlds larger than a node compose hierarchically: the
in-node phase at the NVLink rate plus a cross-node phase at the per-GPU
share of the node's network rate (reduce-style ops move the node-reduced
shard; gather-style ops move every remote node's contribution once into
each node).

Constants (``tests/test_torch_scaling_model.py`` pins them): NVLink-4, 18
links at 25 GB/s one way each, 989 TF/s dense bf16 and 67 TF/s f32 outside
the tensor cores, 3.35 TB/s HBM (NVIDIA's H100 SXM data sheet); the NIC,
one 400 Gb/s ConnectX-7 a GPU (NVIDIA DGX H100); ``gather_rows_per_s`` is
K1's measured rate in this repo (163,840 rows in 0.0174 ms, PERF.md);
``hop_latency_us`` 1 us is an assumption of the model, not measured.  The
numbers are first-order estimates for ranking and capacity planning, not
benchmarks; every hardware constant can be overridden.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

from param_tpu_torch.utils.dtypes import dtype_from_name, dtype_size

# ----------------------------------------------------------------- hardware


@dataclass(frozen=True)
class GenSpec:
    name: str
    link_gbs: float  # one ring direction, per GPU, one way (GB/s)
    node_size: int  # GPUs a node (the largest one-node world)
    gpus_per_host: int
    dcn_gbs_per_host: float  # the node's inter-node network, one way
    hop_latency_us: float = 1.0
    # per-GPU compute roofline
    tflops_bf16: float = 989.0
    tflops_f32: float = 67.0
    hbm_gbs: float = 3350.0
    # K1's rows / s (an embedding lookup's issue ceiling)
    gather_rows_per_s: float = 163840 / 0.0174e-3


GENERATIONS: Dict[str, GenSpec] = {
    "h100": GenSpec("h100", link_gbs=18 * 25.0 / 2, node_size=8,
                    gpus_per_host=8, dcn_gbs_per_host=8 * 50.0),
}


@dataclass(frozen=True)
class Topology:
    """A world: ``n_nodes`` nodes of ``node_gpus`` GPUs each (one node,
    of up to ``node_size`` GPUs, when ``n_nodes`` is 1); a node's GPUs are
    a ring with both directions over its switch."""

    gen: GenSpec
    node_gpus: int
    n_nodes: int = 1

    @property
    def n_gpus(self) -> int:
        return self.node_gpus * self.n_nodes

    @property
    def total_bw(self) -> float:
        """``W``: a GPU's bandwidth for a ring collective over its node,
        both ring directions (a node of one GPU has no links)."""
        return 2.0 * self.gen.link_gbs if self.node_gpus > 1 else 1e-9

    @property
    def dcn_bw_per_gpu(self) -> float:
        return self.gen.dcn_gbs_per_host / self.gen.gpus_per_host

    def layout(self) -> str:
        return f"{self.node_gpus}" + (
            f"*{self.n_nodes}n" if self.n_nodes > 1 else "")


def slice_topology(
    generation: str,
    n_gpus: int,
    hop_latency_us: Optional[float] = None,
    dcn_gbs_per_host: Optional[float] = None,
    link_gbs: Optional[float] = None,
) -> Topology:
    """The world of ``n_gpus`` GPUs: one node up to the node size, else
    whole nodes."""
    gen = GENERATIONS[generation]
    over = {k: v for k, v in (("hop_latency_us", hop_latency_us),
                              ("dcn_gbs_per_host", dcn_gbs_per_host),
                              ("link_gbs", link_gbs)) if v is not None}
    if over:
        gen = replace(gen, **over)
    n_nodes = max(1, -(-n_gpus // gen.node_size))
    if n_nodes > 1 and n_gpus != n_nodes * gen.node_size:
        raise ValueError(f"{n_gpus} GPUs is not a whole number of "
                         f"{gen.node_size}-GPU nodes")
    return Topology(gen=gen, n_nodes=n_nodes,
                    node_gpus=n_gpus if n_nodes == 1 else gen.node_size)


# ------------------------------------------------------------------- model

# collective name aliases -> canonical model entry
_CANON = {
    "all_gather_base": "all_gather",
    "all_gather_v": "all_gather",
    "all_gather_object": "all_gather",
    "reduce_scatter_base": "reduce_scatter",
    "reduce_scatter_v": "reduce_scatter",
    "all_to_allv": "all_to_all",
    "all_to_all_single": "all_to_all",
    "broadcast_object_list": "broadcast",
    "multicast": "scatter",
    "incast": "gather",
    "send": "pt2pt",
    "recv": "pt2pt",
    "isend": "pt2pt",
    "irecv": "pt2pt",
}

_MODELED = frozenset(
    [
        "all_reduce",
        "all_gather",
        "reduce_scatter",
        "all_to_all",
        "broadcast",
        "reduce",
        "gather",
        "scatter",
        "pt2pt",
        "barrier",
    ]
)


def _us(bytes_: float, gbs: float) -> float:
    """bytes at GB/s -> microseconds (1 GB/s == 1 byte/ns)."""
    return bytes_ / max(gbs, 1e-9) / 1e3


def _node_time_us(name: str, B: float, topo: Topology) -> float:
    """One node's wire + latency time (us) for per-rank payload B bytes."""
    n = topo.node_gpus
    if n <= 1:
        return 0.0
    W = topo.total_bw
    lat = (n - 1) * topo.gen.hop_latency_us  # a ring's steps
    frac = (n - 1) / n
    if name == "all_reduce":
        return _us(2.0 * B * frac, W) + 2.0 * lat
    if name in ("all_gather", "reduce_scatter", "broadcast", "reduce"):
        return _us(B * frac, W) + lat
    if name == "all_to_all":
        # switch: each GPU sends (n-1)/n of B, one hop, at its full rate
        return _us(B * frac, W) + lat
    if name in ("gather", "scatter"):
        # incast / outcast bound: every other rank's full B-byte payload
        # funnels through the root's links (sweep convention: per-rank
        # input B, the root holds n.B)
        return _us(B * (n - 1), W) + lat
    if name == "pt2pt":
        # switch: one hop at the GPU's full one-way NVLink rate
        return _us(B, W) + topo.gen.hop_latency_us
    if name == "barrier":
        return lat
    raise ValueError(f"no model for collective {name!r}")


def _dcn_time_us(name: str, B: float, topo: Topology) -> float:
    """The cross-node phase (us) when n_nodes > 1, at the per-GPU share of
    the node's network rate."""
    P = topo.n_nodes
    if P <= 1:
        return 0.0
    w = topo.dcn_bw_per_gpu
    if name == "all_reduce":
        # in-node reduce_scatter leaves each GPU a B/node_gpus shard;
        # shards all_reduce across nodes, then in-node all_gather
        b_shard = B / topo.node_gpus
        return _us(2.0 * b_shard * (P - 1) / P, w)
    if name in ("all_gather", "all_to_all"):
        # every node must ingest each remote node's per-GPU contribution:
        # per GPU, B bytes from each of P-1 nodes (the in-node
        # redistribution is counted in the node phase)
        return _us(B * (P - 1), w)
    if name in ("reduce_scatter", "gather", "scatter", "broadcast", "reduce"):
        # one full payload crosses the network per remote node, pipelined:
        # the per-GPU share is B.(P-1)/P
        return _us(B * (P - 1) / P, w)
    if name == "pt2pt":
        return _us(B, w)
    if name == "barrier":
        return float(P - 1) * topo.gen.hop_latency_us * 10.0
    raise ValueError(f"no model for collective {name!r}")


def predict_collective_us(
    collective: str,
    size_bytes: int,
    topo: Topology,
    bitwidth: int = 32,
) -> float:
    """Predicted wall time (us) of one collective with per-rank payload
    ``size_bytes`` on ``topo``.  ``bitwidth`` models quantized transport
    (wire bytes scale by bitwidth/32, PARAM's comms.py:1149)."""
    name = _CANON.get(collective, collective)
    if name not in _MODELED:
        raise ValueError(f"no model for collective {collective!r}")
    B = float(size_bytes) * (bitwidth / 32.0)
    return _node_time_us(name, B, topo) + _dcn_time_us(name, B, topo)


def predict_compute_us(op, gen: GenSpec,
                       bitwidth: int = 32) -> Optional[float]:
    """Roofline estimate (us) of an embedded compute element of a comm
    trace (``compute:gemm`` / ``compute:emb_lookup``, the replayer's
    run_compute surface; PARAM's prepComputeReplay,
    ``commsTraceReplay.py:853-932``): max(operations over the peak, bytes
    over HBM).  A 16-bit GEMM runs at the tensor cores' bf16 peak, a 4-byte
    one at the f32 peak outside them (the port keeps TF32 off).  A lookup
    also respects K1's measured rows / s.  None for unknown kinds."""
    kind = getattr(op, "compute", None)
    esize = dtype_size(dtype_from_name(getattr(op, "dtype", "float32")
                                       or "float32"))
    reps = max(1, int(getattr(op, "count", 1) or 1))
    if kind == "gemm" and getattr(op, "mm_dims", None):
        m, k, _, n = (list(op.mm_dims) + [1, 1, 1, 1])[:4]
        flops = 2.0 * m * k * n
        bytes_ = (m * k + k * n + m * n) * esize
        peak = gen.tflops_f32 if esize >= 4 else gen.tflops_bf16
        t_ops = flops / (peak * 1e12) * 1e6  # us
        t_hbm = _us(bytes_, gen.hbm_gbs)
        return reps * max(t_ops, t_hbm)
    if kind == "emb_lookup":
        rows = max(1, op.batch_size) * max(1, op.bag_size)
        bytes_ = rows * max(1, op.emb_dim) * esize
        t_hbm = _us(bytes_, gen.hbm_gbs)
        t_issue = rows / gen.gather_rows_per_s * 1e6
        return reps * max(t_hbm, t_issue)
    return None


def predicted_bus_bw(
    collective: str, size_bytes: int, topo: Topology, bitwidth: int = 32
) -> float:
    """busBW (GB/s) implied by the model, comparable to the sweep's
    COMMS-RES busBW column and to ``utils.bw.bus_bw``."""
    from param_tpu_torch.utils.bw import bus_bw

    t = predict_collective_us(collective, size_bytes, topo, bitwidth)
    return bus_bw(collective, size_bytes, t, topo.n_gpus, bitwidth)


# ------------------------------------------------------------- trace level


@dataclass
class OpPrediction:
    name: str
    size_bytes: int
    time_us: float
    count: int = 1


@dataclass
class TracePrediction:
    topo: Topology
    per_op: Dict[str, OpPrediction] = field(default_factory=dict)
    total_us: float = 0.0
    total_bytes: int = 0
    n_ops: int = 0
    skipped: int = 0
    compute_us: float = 0.0
    n_compute: int = 0

    @property
    def serial_us(self) -> float:
        """Iteration bound with no comm / compute overlap."""
        return self.total_us + self.compute_us

    @property
    def overlap_us(self) -> float:
        """Iteration bound with perfect comm / compute overlap."""
        return max(self.total_us, self.compute_us)

    def row(self) -> dict:
        return {
            "world": self.topo.n_gpus,
            "nodes": self.topo.layout(),
            "ops": self.n_ops,
            "bytes": self.total_bytes,
            "comm_us": round(self.total_us, 1),
            "compute_us": round(self.compute_us, 1),
            "serial_us": round(self.serial_us, 1),
            "overlap_us": round(self.overlap_us, 1),
        }


def predict_trace(
    ops: Sequence,
    topo: Topology,
    bitwidth: int = 32,
) -> TracePrediction:
    """Predict the serialized comm time of a parsed op stream
    (:class:`param_tpu_torch.trace.comms_trace.CommsOp`) on ``topo``.

    Message sizes are taken from the trace as they are: in/out_msg_size
    are per-rank element counts (the replayer's convention, PARAM's
    commsTraceReplay.py:636-679), so the recorded per-rank payload is the
    model's B at any world size: this rank's recorded traffic pattern, run
    again on a w-GPU world.  Compute elements are predicted by
    :func:`predict_compute_us`; unmodeled ops count in ``skipped``."""
    pred = TracePrediction(topo=topo)
    for op in ops:
        name = getattr(op, "comms", None)
        if not name:
            tc = predict_compute_us(op, topo.gen, bitwidth)
            if tc is not None:
                pred.compute_us += tc
                pred.n_compute += 1
            elif getattr(op, "compute", None):
                pred.skipped += 1  # unknown compute kind
            continue
        if name in ("wait", "init"):
            continue
        canon = _CANON.get(name, name)
        if canon not in _MODELED:
            pred.skipped += 1
            continue
        elems = max(
            int(getattr(op, "in_msg_size", 0) or 0),
            int(getattr(op, "out_msg_size", 0) or 0),
        )
        esize = dtype_size(dtype_from_name(getattr(op, "dtype", "float32")
                                           or "float32"))
        B = elems * esize
        t = predict_collective_us(name, B, topo, bitwidth=bitwidth)
        pred.total_us += t
        pred.total_bytes += B
        pred.n_ops += 1
        agg = pred.per_op.get(canon)
        if agg is None:
            pred.per_op[canon] = OpPrediction(canon, B, t)
        else:
            agg.count += 1
            agg.size_bytes += B
            agg.time_us += t
    return pred


def predict_worlds(
    ops: Sequence,
    generation: str,
    worlds: Sequence[int],
    bitwidth: int = 32,
    **topo_kw,
) -> List[TracePrediction]:
    """What-if sweep: the trace's comm cost on each world size."""
    return [
        predict_trace(ops, slice_topology(generation, w, **topo_kw), bitwidth)
        for w in worlds
    ]


def format_report(preds: Sequence[TracePrediction]) -> str:
    """COMMS-RES-style table of the what-if sweep.  ``serial`` /
    ``overlap`` bracket the iteration time (no vs perfect comm / compute
    overlap)."""
    lines = [
        f"{'world':>6} {'nodes':>16} {'ops':>6} {'skip':>5} "
        f"{'GB moved':>10} {'comm ms':>10} {'compute ms':>11} "
        f"{'serial ms':>10} {'overlap ms':>11}"
    ]
    for p in preds:
        gb = p.total_bytes / 1e9
        lines.append(
            f"{p.topo.n_gpus:>6} {p.topo.layout():>16} {p.n_ops:>6} "
            f"{p.skipped:>5} {gb:>10.3f} {p.total_us/1e3:>10.3f} "
            f"{p.compute_us/1e3:>11.3f} {p.serial_us/1e3:>10.3f} "
            f"{p.overlap_us/1e3:>11.3f}"
        )
    return "\n".join(lines)
