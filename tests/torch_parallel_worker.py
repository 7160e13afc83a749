"""One rank of a gloo world for ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py STORE_FILE RANK WORLD IN_FILE OUT_DIR

Reads the inputs that the test process wrote to IN_FILE (a pickle of numpy
arrays: the reference's parameters and seeded activations of every case),
runs the port's multi-device tier on this rank's shards (ring attention,
head-parallel flash, the MoE layer and its train step, the dp x tp, pipeline
and MLP steps, a ring hop and its backward) and saves the results to
``OUT_DIR/rank<RANK>.pt``.  It imports torch, numpy and the port only (no
JAX).
"""

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (causal, head dim, local sequence)
RING_CASES = [(False, 64, 128), (True, 64, 128), (False, 128, 256),
              (True, 128, 256)]
# (dp, tp, kv heads) for each world size
TP_CASES = {2: [(1, 2, None)], 4: [(2, 2, None), (1, 4, None), (2, 2, 2)]}
PP_MICROBATCHES = {2: [2, 4], 4: [4]}
MOE_CFS = (0.2, 1.25, 8.0, 16.0)
MLP_MESHES = {2: [(1, 2)], 4: [(2, 2)]}
TFM = dict(seq=64, emb=128, heads=4, ffn=256, dtype="float32")
PP_TFM = dict(seq=64, emb=64, heads=2, ffn=128, dtype="float32")
MOE = dict(emb=16, ffn=32, tokens=16)
TP_LR, PP_LR, MOE_LR, MLP_LR = 0.1, 0.1, 0.1, 0.01


def _np(ts):
    return [t.detach().cpu().numpy() for t in ts]


def main(store, rank, world, in_file, out_dir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.models import convert, moe, transformer as tfm
    from param_tpu_torch.models.parallel import RingHop, mesh_groups
    from param_tpu_torch.ops.attention import flash_mha
    from param_tpu_torch.ops.mlp import make_tp_mlp_train_step
    from param_tpu_torch.ops.ring_attention import ring_attention

    torch.set_num_threads(1)
    with open(in_file, "rb") as f:
        data = pickle.load(f)[world]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    backend = DistBackend("cpu")
    backend.initialize()
    group = backend.get_default_group()
    n, res = world, {}

    for case in RING_CASES:
        s = case[2]
        q, k, v = (torch.from_numpy(t[:, :, rank * s:(rank + 1) * s].copy())
                   for t in data["ring", case])
        res["ring", case] = ring_attention(q, k, v, group,
                                           causal=case[0]).numpy()

    # head-parallel flash: this rank's heads, as the tp step runs them
    h = 2
    q, k, v = (torch.from_numpy(t[:, rank * h:(rank + 1) * h].copy())
               for t in data["heads"])
    res["heads"] = flash_mha(q, k, v, True).numpy()

    tokens = MOE["tokens"]
    x = torch.from_numpy(data["moe_x"][rank * tokens:(rank + 1) * tokens])
    mine = convert.moe_expert_from_jax(data["moe_params"], rank, "cpu")
    for cf in MOE_CFS:
        cfg = moe.MoeConfig(MOE["emb"], MOE["ffn"], n, capacity_factor=cf)
        res["moe", cf] = moe.moe_apply_ep(mine, x, group, cfg).numpy()
    cfg = moe.MoeConfig(MOE["emb"], MOE["ffn"], n)
    new, loss = moe.make_moe_train_step(group, cfg, MOE_LR)(mine, x)
    res["moe_train"] = (loss.item(), _np(new[k] for k in moe.KEYS))

    for dp, tp, kv in TP_CASES[n]:
        cfg = tfm.TransformerConfig(batch=4, kv_heads=kv, **TFM)
        groups = mesh_groups(backend, dp, tp)
        i, j = groups.dp_index, groups.tp_index
        p = convert.tp_shard_from_jax(data["tp", kv]["params"], cfg, j, tp,
                                      "cpu")
        xs = torch.from_numpy(data["tp", kv]["x"]).chunk(dp)[i]
        p, loss = tfm.make_sharded_train_step(groups, cfg, TP_LR)(p, xs)
        res["tp", dp, tp, kv] = (loss.item(), {k: _np(v) if isinstance(
            v, tuple) else v.numpy() for k, v in p.items()})

    for m in PP_MICROBATCHES[n]:
        cfg = tfm.TransformerConfig(batch=2 * m, **PP_TFM)
        block = convert.stage_params_from_jax(data["pp", m]["params"], rank,
                                              "cpu")
        x = torch.from_numpy(data["pp", m]["x"])
        block, loss = tfm.make_pipeline_train_step(group, cfg, m, PP_LR)(
            block, x)
        res["pp", m] = (loss.item(), _np(tfm.leaves(block)))

    for dp, tp in MLP_MESHES[n]:
        groups = mesh_groups(backend, dp, tp)
        i, j = groups.dp_index, groups.tp_index
        p = convert.mlp_tp_shard_from_jax(data["mlp"]["params"], j, tp, "cpu")
        x, y = (torch.from_numpy(t).chunk(dp)[i]
                for t in (data["mlp"]["x"], data["mlp"]["y"]))
        p, loss = make_tp_mlp_train_step(groups, MLP_LR)(p, x, y)
        res["mlp", dp, tp] = (loss.item(), [_np(pair) for pair in p])

    # a hop forward, and its backward the reverse hop: d sum(w * hop(x)) /
    # dx = w of the next rank
    xr = torch.full((3,), float(rank), requires_grad=True)
    w = torch.full((3,), 10.0 + rank)
    got = RingHop.apply(xr, group)
    (got * w).sum().backward()
    res["hop"] = (got.detach().numpy(), xr.grad.numpy())

    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    backend.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
