"""One rank of a gloo world for ``tests/test_torch_et_sharded.py``.

    python tests/torch_et_worker.py STORE_FILE RANK WORLD IN_FILE OUT_DIR

Reads the full parameters and a batch that the test process wrote to
IN_FILE (a pickle of numpy arrays) and runs ``experiments.et_sharded.check``
on this rank's shard of them: the capture of the port's table-wise sharded
dense SGD step, its replay with the real inputs on the live world, and the
direct step.  Saves both results, the check's record, the comm ops that
``comms_from_et`` gives and the trace's comm nodes to
``OUT_DIR/rank<RANK>.pt`` (the trace itself to ``OUT_DIR/rank<RANK>_et.json``).
It imports torch, numpy and the port only (no JAX).
"""

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(store, rank, world, in_file, out_dir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.experiments.et_sharded import check
    from param_tpu_torch.models.convert import params_shard_from_jax
    from param_tpu_torch.models.dlrm import DlrmConfig
    from param_tpu_torch.trace.comms_trace import comms_from_et

    torch.set_num_threads(1)
    with open(in_file, "rb") as f:
        data = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    backend = DistBackend("cpu")
    backend.initialize()
    rec, et, got, want = check(
        backend, DlrmConfig(**data["cfg"]),
        params=params_shard_from_jax(data["params"], rank, world, "cpu"),
        batch=data["batch"])
    et.save(os.path.join(out_dir, f"rank{rank}_et.json"))
    res = {
        "record": rec,
        "replayed": [t.detach().numpy() for t in got],
        "direct": [t.detach().numpy() for t in want],
        "comms": [(c.comms, c.in_msg_size, c.out_msg_size, c.world_size)
                  for c in comms_from_et(et, world)],
        "comm_nodes": [n.name for n in et.comm_nodes()],
    }
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    backend.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
