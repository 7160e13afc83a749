"""One rank of a gloo world for ``tests/test_torch_dlrm_sharded.py``.

    python tests/torch_dlrm_worker.py STORE_FILE RANK WORLD IN_FILE OUT_DIR [spans]

Reads the full parameters and batches that the test process wrote to
IN_FILE (a pickle of numpy arrays), runs the port's sharded DLRM on this
rank's shard (the sharded loss, value and grad, two steps of each optimizer,
the ragged loss and exchange on both wires, the comm bench's pattern and a
short run of every region), and saves the results to
``OUT_DIR/rank<RANK>.pt``.  With ``spans`` (``tests/test_torch_spans.py``)
it instead runs the sparse steps under a CPU profiler and saves the span
record of each optimizer.  It imports torch, numpy and the port only (no
JAX).
"""

import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
OPTIMIZERS = ("sgd", "adagrad", "sparse_sgd", "sparse_adagrad")
WIRES = ("padded", "ragged")


def _np(tree):
    """A params tree's leaves as numpy, in order."""
    out = [tree["tables"]]
    for key in ("bot", "top"):
        for w, b in tree[key]:
            out += [w, b]
    return [t.detach().cpu().numpy() for t in out]


def _train(model, opt_name, params, batches):
    from param_tpu_torch.ops.mlp import make_optimizer

    losses, acc = [], None
    if opt_name in ("sgd", "adagrad"):
        opt = make_optimizer(opt_name, LR)
        step = model.make_train_step(opt)
        acc = opt.init(params)
        for b in batches:
            params, acc, loss = step(params, acc, *b)
            losses.append(float(loss))
        acc = acc if opt_name == "adagrad" else None
    elif opt_name == "sparse_sgd":
        step = model.make_sparse_sgd_step(LR)
        for b in batches:
            params, loss = step(params, *b)
            losses.append(float(loss))
    else:
        step = model.make_sparse_adagrad_step(LR)
        acc = model.init_adagrad_state(params)
        for b in batches:
            params, acc, loss = step(params, acc, *b)
            losses.append(float(loss))
    return losses, _np(params), None if acc is None else _np(acc)


def _spans(model, fresh, batches):
    """{optimizer: (span totals, counter totals)} of the sparse steps over
    ``batches`` under a CPU profiler."""
    import torch

    from param_tpu_torch.utils import profiler

    out = {}
    for opt in ("sparse_sgd", "sparse_adagrad"):
        params = fresh()
        acc = model.init_adagrad_state(params)
        step = (model.make_sparse_sgd_step(LR) if opt == "sparse_sgd"
                else model.make_sparse_adagrad_step(LR))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            profiler.reset()
            for b in batches:
                if opt == "sparse_sgd":
                    step(params, *b)
                else:
                    step(params, acc, *b)
        out[opt] = (profiler.span_totals(), profiler.counter_totals())
    return out


def main(store, rank, world, in_file, out_dir, mode="all"):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.models.convert import params_shard_from_jax
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_bench import DlrmCommBench
    from param_tpu_torch.models.ragged import ragged_sparse_dist
    from param_tpu_torch.ops.mlp import make_optimizer

    torch.set_num_threads(1)
    with open(in_file, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    backend = DistBackend("cpu")
    backend.initialize()
    group = backend.get_default_group()
    model = DlrmModel(DlrmConfig(**data["cfg"]), group=group, device="cpu")
    fresh = lambda: params_shard_from_jax(data["params"], rank, world, "cpu")  # noqa: E731
    batches = [model.place_batch(b) for b in data["batches"]]
    if mode == "spans":
        torch.save(_spans(model, fresh, batches),
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return
    res = {}

    res["loss"] = float(model.make_sharded_loss()(fresh(), *batches[0]))
    loss, grads = model.make_value_and_grad()(fresh(), *batches[0])
    res["vg"] = (float(loss), _np(grads))
    for opt in OPTIMIZERS:
        res[f"train:{opt}"] = _train(model, opt, fresh(), batches)

    ragged_params = params_shard_from_jax(data["ragged_params"], rank, world,
                                          "cpu")
    dense, idx, labels = data["batches"][0]
    for name, lengths in data["lengths"].items():
        b = model.place_batch((dense, lengths, idx, labels))
        for wire in WIRES:
            res[f"ragged_loss:{name}:{wire}"] = float(
                model.make_sharded_loss_ragged(wire)(ragged_params, *b))
            lt, it = ragged_sparse_dist(b[1], b[2], group,
                                        pad_row=data["cfg"]["rows_per_table"],
                                        wire=wire)
            res[f"ragged_dist:{name}:{wire}"] = (lt.numpy(), it.numpy())

    for opt in ("adagrad", "sparse_adagrad"):
        bench = DlrmCommBench(model, opt if opt.startswith("sparse")
                              else make_optimizer(opt, LR), lr=LR)
        res["comms_trace"] = bench.comms_trace()
        res["memory"] = bench.region_memory_bytes()
        res[f"bench:{opt}"] = bench.run(reps=2, chain=1, max_chain=2)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    backend.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
