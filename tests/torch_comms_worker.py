"""One rank of a gloo world for ``tests/test_torch_comms.py``.

    python tests/torch_comms_worker.py STORE_FILE RANK WORLD OUT_DIR

Runs every collective case of :func:`cases` on this rank's inputs through
``param_tpu_torch``'s DistBackend, and the harness's dcheck on a few
collectives, then saves the results to ``OUT_DIR/rank<RANK>.pt``.  It
imports torch, numpy and the port only (no JAX), so the test process can
import :func:`cases` and :func:`inputs` to feed the reference the same data.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(n):
    """(name, collective, CollectiveArgs fields, local shape) of the parity
    cases for a world of n ranks (n >= 2)."""
    S = (np.arange(n * n).reshape(n, n) * 7 + 3) % 4  # all_to_allv matrix
    pairs = [(0, n - 1), (n - 1, 0)] if n > 2 else [(0, 1)]
    return [
        ("all_reduce_sum", "all_reduce", {}, (8,)),
        ("all_reduce_max", "all_reduce", {"red_op": "max"}, (8,)),
        ("all_reduce_avg", "all_reduce", {"red_op": "avg"}, (8,)),
        ("all_reduce_prod", "all_reduce", {"red_op": "prod"}, (8,)),
        ("reduce_sum_root1", "reduce", {"dst_rank": 1}, (8,)),
        ("reduce_max_root0", "reduce", {"red_op": "max"}, (8,)),
        ("all_gather", "all_gather", {}, (6,)),
        ("all_gather_2d", "all_gather", {}, (4, 3)),
        ("all_gather_v", "all_gather_v",
         {"in_split": [3, 8, 5, 1][:n]}, (8,)),
        ("reduce_scatter_sum", "reduce_scatter", {}, (4 * n,)),
        ("reduce_scatter_max", "reduce_scatter", {"red_op": "max"}, (4 * n,)),
        ("reduce_scatter_v", "reduce_scatter_v",
         {"out_split": [3, 5, 2, 6][:n]}, (16,)),
        ("all_to_all", "all_to_all", {}, (2 * n,)),
        ("all_to_allv_matrix", "all_to_allv",
         {"in_split": S.tolist()}, (int(S.sum(axis=1).max()) + 2,)),
        ("all_to_allv_shared", "all_to_allv",
         {"in_split": [2] * n}, (2 * n,)),
        ("broadcast_root1", "broadcast", {"src_rank": 1}, (8,)),
        ("gather_root1", "gather", {"dst_rank": 1}, (5,)),
        ("scatter_root1", "scatter", {"src_rank": 1}, (2 * n,)),
        ("incast", "incast", {"dst_rank": 0}, (5,)),
        ("multicast", "multicast", {"src_rank": 1}, (5,)),
        ("pt2pt", "pt2pt", {"src_ranks": [s for s, _ in pairs],
                            "dst_ranks": [d for _, d in pairs]}, (6,)),
    ]


def inputs(name, n, shape):
    """Per-rank inputs of a case: small integers as f32, so every sum,
    product and average over up to 4 ranks is exact in any order."""
    seed = sum(map(ord, name)) * 31 + n
    rng = np.random.default_rng(seed)
    hi = 3 if "prod" in name else 9
    return [rng.integers(-hi, hi + 1, size=shape).astype(np.float32)
            for _ in range(n)]


def reuse_pairs(n):
    """The one (src, dst) pair of the pt2pt buffer-reuse calls."""
    return [(0, n - 1)]


# the pt2pt calls made twice each with the same shape and pairs, so the
# second runs in the first's receive buffers: (name, backend method, args)
REUSE_CALLS = [
    ("send_recv", "send_recv", ()),
    ("ping", "ping", ()),
    ("ping_pong", "ping", (True,)),
    ("window_uni", "window_send", (3, False)),
    ("window_bi", "window_send", (3, True)),
]


DCHECK_COLLECTIVES = ["all_reduce", "all_gather", "reduce_scatter",
                      "all_to_all", "all_to_allv", "broadcast", "reduce",
                      "gather", "scatter", "incast", "multicast",
                      "all_gather_v", "reduce_scatter_v", "all_gather_object",
                      "broadcast_object_list"]


def main(store, rank, world, out_dir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from param_tpu_torch.backend import CollectiveArgs, DistBackend
    from param_tpu_torch.comms.coll_bench import CollBench
    from param_tpu_torch.comms.harness import CommsParams

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    backend = DistBackend("cpu")
    backend.initialize()
    res = {}
    for name, coll, kw, shape in cases(world):
        x = torch.from_numpy(inputs(name, world, shape)[rank])
        res[name] = backend.collective_fn[coll](
            CollectiveArgs(in_tensor=x, **kw))
    res["all_gather_object"] = backend.all_gather_object(CollectiveArgs(
        misc={"objects": [{"rank": r, "v": [r] * r} for r in range(world)]}))
    res["broadcast_object_list"] = backend.broadcast_object_list(
        CollectiveArgs(src_rank=1, misc={"object_list": [
            {"root": rank}, f"from {rank}"]}))
    pairs = reuse_pairs(world)
    args = CollectiveArgs(
        in_tensor=torch.from_numpy(inputs("pt2pt_reuse", world, (7,))[rank]),
        src_ranks=[p for p, _ in pairs], dst_ranks=[q for _, q in pairs])
    for name, method, extra in REUSE_CALLS:
        fn = getattr(backend, method)
        out = fn(args, *extra)
        first, ptr = out.clone(), out.data_ptr()
        out = fn(args, *extra)
        res[f"reuse:{name}"] = (first, out.clone(), out.data_ptr() == ptr)
    bench = CollBench(backend, CommsParams(num_iters=2, num_warmup_iters=1,
                                           dcheck=True), reps=1)
    g = backend.get_default_group()
    for coll in DCHECK_COLLECTIVES:
        res[f"dcheck:{coll}"] = bench.run_one(coll, 256, g).dcheck_ok
    res["dcheck:pt2pt"] = bench.bench_pt2pt(256, g)[1]
    # the pt2pt rows of a small sweep in both timing modes: (size, dcheck,
    # ping us, ping-pong us, uni GB/s, bi GB/s) per row
    for mode in ("dispatch", "graph"):
        params = CommsParams(begin_size=64, end_size=256, num_iters=2,
                             num_warmup_iters=1, dcheck=True, window=3)
        params.mode = params.mode.__class__(mode)
        mbench = CollBench(backend, params, reps=1)
        rows = [mbench.bench_pt2pt(size, g)
                for size in mbench.sweep_sizes("pt2pt", g)]
        res[f"pt2pt:{mode}"] = [
            (m.input_size_bytes, ok, m.ping_p50_us, m.ping_pong_p50_us,
             m.uni_bw_gbs, m.bi_bw_gbs) for m, ok in rows]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    backend.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
