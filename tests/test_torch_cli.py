"""The port's DLRM trainer CLI on the CPU, and the rules of the port's package:
no JAX and nothing of the reference package, and no silent CPU fallback."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from param_tpu_torch.cli import dlrm as cli

TINY = ["--num-tables", "4", "--rows", "512", "--emb-dim", "16", "--nnz", "4",
        "--dense-dim", "16", "--arch-mlp-bot", "32-16", "--arch-mlp-top",
        "32-1", "--batch", "64"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("optimizer",
                         ["sgd", "adagrad", "sparse_sgd", "sparse_adagrad"])
def test_train_e2e_on_cpu(optimizer, capsys):
    rc = cli.main(TINY + ["--device", "cpu", "--train-batches", "3",
                          "--optimizer", optimizer])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(m) for m in re.findall(r"^batch\s+\d+\s+loss (\S+)$", out,
                                           re.M)]
    assert len(losses) == 3 and all(l == l for l in losses)  # finite, not NaN
    line = [ln for ln in out.splitlines() if ln.startswith("DLRM-E2E")]
    assert len(line) == 1 and "batches=3" in line[0] and "AUC=" in line[0]
    assert "device=cpu" in line[0]


def test_sparse_and_dense_losses_agree(capsys):
    """Sparse SGD is exact for sum pooling: same loss curve as dense SGD."""
    curves = {}
    for opt in ("sgd", "sparse_sgd"):
        cli.main(TINY + ["--device", "cpu", "--train-batches", "3",
                         "--optimizer", opt])
        curves[opt] = re.findall(r"loss (\S+)", capsys.readouterr().out)
    assert curves["sgd"] == curves["sparse_sgd"]


def test_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(TINY + ["--train-batches", "1"])


def test_unported_modes_raise():
    """The region bench and --print-comms are ported
    (tests/test_torch_dlrm_sharded.py); the TPU's lane-packed tables stay
    refused."""
    with pytest.raises(SystemExit):
        cli.main(TINY + ["--device", "cpu", "--packed-tables",
                         "--train-batches", "1"])


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|param_tpu|scripts)(\.|\s|$)",
                        re.M)


_COMMS_MODULES = ["param_tpu_torch/backend/base.py",
                  "param_tpu_torch/backend/dist_backend.py",
                  "param_tpu_torch/comms/harness.py",
                  "param_tpu_torch/comms/coll_bench.py",
                  "param_tpu_torch/cli/comms.py",
                  "param_tpu_torch/ops/ring_collectives.py",
                  "param_tpu_torch/kernels/ring.py",
                  "tests/torch_comms_worker.py",
                  "param_tpu_torch/models/dlrm_bench.py",
                  "param_tpu_torch/models/ragged.py",
                  "tests/torch_dlrm_worker.py",
                  "param_tpu_torch/models/parallel.py",
                  "param_tpu_torch/models/moe.py",
                  "param_tpu_torch/ops/ring_attention.py",
                  "param_tpu_torch/experiments/parallel_tier.py",
                  "tests/torch_parallel_worker.py",
                  "param_tpu_torch/comms/quantization.py",
                  "param_tpu_torch/comms/overlap_bench.py",
                  "param_tpu_torch/backend/mock_backend.py",
                  "param_tpu_torch/backend/torchcomms.py",
                  "param_tpu_torch/cli/overlap.py",
                  "param_tpu_torch/cli/comms_compute.py",
                  "param_tpu_torch/cli/replay.py",
                  "param_tpu_torch/trace/replay.py",
                  "param_tpu_torch/trace/device_trace.py",
                  "tests/torch_remainder_worker.py",
                  "param_tpu_torch/trace/execution_trace.py",
                  "param_tpu_torch/trace/capture.py",
                  "param_tpu_torch/trace/et_replay.py",
                  "param_tpu_torch/cli/et.py",
                  "tests/torch_et_worker.py",
                  "param_tpu_torch/trace/pytorch_op_replay.py",
                  "param_tpu_torch/trace/attention_fusion.py",
                  "param_tpu_torch/trace/scaling_model.py",
                  "param_tpu_torch/cli/pt_et.py",
                  "param_tpu_torch/cli/analyze.py",
                  "param_tpu_torch/cli/scaling.py",
                  "param_tpu_torch/microbench/__init__.py",
                  "param_tpu_torch/microbench/generator.py",
                  "param_tpu_torch/microbench/iterator.py",
                  "param_tpu_torch/microbench/data.py",
                  "param_tpu_torch/microbench/operator.py",
                  "param_tpu_torch/microbench/benchmark.py",
                  "param_tpu_torch/microbench/workloads/__init__.py",
                  "param_tpu_torch/microbench/workloads/basic_ops.py",
                  "param_tpu_torch/microbench/workloads/batched_embedding.py",
                  "param_tpu_torch/microbench/workloads/convnets.py",
                  "param_tpu_torch/ops/cvt_convs.py",
                  "param_tpu_torch/ops/matmul_tune.py",
                  "param_tpu_torch/cli/run_benchmark.py",
                  "param_tpu_torch/cli/cvt.py"]


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_comms_worker.py"),
             os.path.join(ROOT, "tests", "torch_dlrm_worker.py"),
             os.path.join(ROOT, "tests", "torch_parallel_worker.py"),
             os.path.join(ROOT, "tests", "torch_remainder_worker.py"),
             os.path.join(ROOT, "tests", "torch_et_worker.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "param_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    assert {os.path.join(ROOT, m) for m in _COMMS_MODULES} <= set(files)
    bad = []
    for f in files:
        with open(f) as fh:
            bad += [f"{f}: {m.group(0).strip()}"
                    for m in _FORBIDDEN.finditer(fh.read())]
    assert not bad, bad


def test_bench_and_experiment_load_without_jax():
    """The headline bench and the coalesced-fetch experiment pull in
    neither JAX, the reference package nor its scripts."""
    code = ("import sys\n"
            "import param_tpu_torch.bench, param_tpu_torch.experiments.coalesce\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu', 'scripts')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


def test_comms_and_ring_modules_load_without_jax():
    """Importing the comms tier and the rings pulls in neither JAX nor the
    reference package (the spawned ranks of the comms tests rely on it)."""
    code = ("import sys\n"
            "import param_tpu_torch.backend, param_tpu_torch.comms.coll_bench\n"
            "import param_tpu_torch.cli.comms\n"
            "import param_tpu_torch.ops.ring_collectives\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


def test_sharded_dlrm_modules_load_without_jax():
    """Importing the sharded DLRM, its bench, the ragged exchange and the
    CLI pulls in neither JAX nor the reference package (the spawned ranks
    of the sharded tests rely on it)."""
    code = ("import sys\n"
            "import param_tpu_torch.models.dlrm_bench\n"
            "import param_tpu_torch.models.ragged, param_tpu_torch.cli.dlrm\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


def test_parallel_tier_modules_load_without_jax():
    """Importing the multi-device transformer tier (collectives, ring
    attention, MoE, the steps and their checks) pulls in neither JAX nor
    the reference package (the spawned ranks of its tests and torchrun's
    ranks on the cards rely on it)."""
    code = ("import sys\n"
            "import param_tpu_torch.experiments.parallel_tier\n"
            "import param_tpu_torch.models.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


def test_comms_remainder_and_trace_modules_load_without_jax():
    """Importing the quantized collectives, the facade and mock backends,
    the overlap benches, the trace tier and their CLIs pulls in neither
    JAX nor the reference package (the spawned ranks of their tests rely
    on it)."""
    code = ("import sys\n"
            "import param_tpu_torch.cli.overlap, param_tpu_torch.cli.replay\n"
            "import param_tpu_torch.cli.comms_compute\n"
            "import param_tpu_torch.comms.overlap_bench\n"
            "import param_tpu_torch.comms.quantization\n"
            "import param_tpu_torch.trace.replay\n"
            "import param_tpu_torch.trace.device_trace\n"
            "import param_tpu_torch.trace.export_pytorch_et\n"
            "import param_tpu_torch.trace.profiler_analysis\n"
            "import param_tpu_torch.backend.torchcomms\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


def test_microbench_modules_load_without_jax():
    """The operator microbench (its workloads loaded), the CvT layers, the
    K3 schedule tuner and their CLIs pull in neither JAX nor the reference
    package."""
    code = ("import sys\n"
            "import param_tpu_torch.microbench\n"
            "from param_tpu_torch.microbench.operator import load_workloads\n"
            "import param_tpu_torch.microbench.benchmark\n"
            "load_workloads()\n"
            "import param_tpu_torch.ops.cvt_convs\n"
            "import param_tpu_torch.ops.matmul_tune\n"
            "import param_tpu_torch.cli.run_benchmark, param_tpu_torch.cli.cvt\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


def test_et_modules_load_without_jax():
    """The execution-trace tier and its CLI, and a generated replay script
    (``import param_tpu_torch.kernels`` for K1 / K2's ops), pull in neither
    JAX nor the reference package."""
    code = ("import sys\n"
            "import param_tpu_torch.trace.execution_trace\n"
            "import param_tpu_torch.trace.capture\n"
            "import param_tpu_torch.trace.et_replay\n"
            "import param_tpu_torch.cli.et, param_tpu_torch.kernels\n"
            "import torch\n"
            "assert torch.ops.param_tpu_torch.emb_gather.default\n"
            "assert torch.ops.param_tpu_torch.sparse_update.default\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("workload", ["dlrm", "mlp", "dlrm_train"])
def test_et_cli_on_cpu(workload, tmp_path, capsys):
    """``cli.et`` capture / validate / replay / codegen with ``--device
    cpu``: a clean trace, a replay with no error or skipped node, and a
    script with one call per op."""
    import json

    from param_tpu_torch.cli import et

    path, script = str(tmp_path / "et.json.gz"), str(tmp_path / "replay.py")
    assert et.main(["capture", "--workload", workload, "-o", path,
                    "--iterations", "2", "--device", "cpu"]) == 0
    n_ops = int(re.search(r"captured (\d+) ops", capsys.readouterr().out)[1])
    assert n_ops > 3
    assert et.main(["validate", path]) == 0
    assert f"ops={n_ops} comm_ops=0 errors=0" in capsys.readouterr().out
    assert et.main(["--device", "cpu", "replay", path, "--iters", "2",
                    "--alloc", "lazy", "--per-op"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["errors"] == {} and report["num_skipped"] == 0
    assert report["num_ops"] == n_ops and report["trace_iterations"] == 2
    assert sum(v["count"] for v in report["per_op_us"].values()) == n_ops
    assert et.main(["codegen", path, "-o", script, "--device", "cpu"]) == 0
    code = open(script).read()
    assert code.count("torch.ops.") == n_ops // 2
    assert code.rstrip().endswith(f'print("replayed {n_ops // 2} ops OK")')


def test_et_cli_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from param_tpu_torch.cli import et

    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        et.main(["capture", "--workload", "mlp", "-o",
                 str(tmp_path / "et.json")])


def test_pt_et_modules_load_without_jax():
    """The op-level replay, attention fusion, scaling model and their CLIs
    pull in neither JAX nor the reference package."""
    code = ("import sys\n"
            "import param_tpu_torch.trace.pytorch_op_replay\n"
            "import param_tpu_torch.trace.attention_fusion\n"
            "import param_tpu_torch.trace.scaling_model\n"
            "import param_tpu_torch.cli.pt_et, param_tpu_torch.cli.analyze\n"
            "import param_tpu_torch.cli.scaling\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr


_TRAIN_ET = os.path.join(ROOT, "tests", "fixtures", "transformer_train_et"
                         ".json.gz")


def test_pt_et_parser():
    from param_tpu_torch.cli import pt_et

    ns = pt_et.build_parser().parse_args(["--trace", "x.json", "--chain",
                                          "--max-ops", "10"])
    assert ns.chain and ns.max_ops == 10 and ns.device == "cuda"
    assert ns.backend == "dist" and ns.mode == "comp"
    with pytest.raises(SystemExit):
        pt_et.build_parser().parse_args(["--trace", "x", "--backend", "tpu"])


@pytest.mark.parametrize("extra", [[], ["--fuse", "attention-train",
                                        "--cast", "bf16"], ["--chain"]])
def test_pt_et_main_on_cpu(extra, tmp_path, capsys):
    """``cli.pt_et`` on the small training fixture with ``--device cpu``:
    every op replayed (the fused windows counted), nothing skipped."""
    from param_tpu_torch.cli import pt_et

    out_json = str(tmp_path / "report.json")
    assert pt_et.main(["--trace", _TRAIN_ET, "--device", "cpu",
                       "--output-json", out_json] + extra) == 0
    out = capsys.readouterr().out
    assert "selected 226 ATen ops (schema 1.1.1-chakra.0.0.4)" in out
    report = json.loads(open(out_json).read())
    assert report["skipped"] == {} and report["num_selected"] == 226
    if "--chain" in extra:
        assert "fused-iteration time:" in out
        assert report["chain_iteration_s"] > 0
    elif "--fuse" in extra:
        assert "fused 2 attention windows (14 ops)" in out
        assert "fused 2 attention BACKWARD windows (26 ops)" in out
        assert report["num_executed"] == 190
        assert report["per_op"]["fused::flash_attention_bwd"]["count"] == 2
    else:
        assert report["num_executed"] == 226 and "executed 226 ops" in out


def test_pt_et_codegen_and_skip_config(tmp_path, capsys):
    from param_tpu_torch.cli import pt_et

    script, cfg = str(tmp_path / "gen.py"), str(tmp_path / "skip.json")
    with open(cfg, "w") as f:
        json.dump({"skip nodes": {"aten::gelu": "pre-skip"}}, f)
    assert pt_et.main(["--trace", _TRAIN_ET, "--device", "cpu",
                       "--codegen", script, "--skip-config", cfg]) == 0
    assert f"-> {script}" in capsys.readouterr().out
    src = open(script).read()
    assert src.count("# skipped: aten::gelu (pre-skip)") == 2
    assert "replayed 224 ops OK" in src


def test_pt_et_needs_cuda_unless_cpu_is_asked_for():
    from param_tpu_torch.cli import pt_et

    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_et.main(["--trace", _TRAIN_ET])


def test_pt_et_full_mode_on_mock_backend(capsys):
    """``--mode full --backend mock``: a trace without comm records
    replays its compute stream; the mock backend needs no process group."""
    from param_tpu_torch.cli import pt_et

    assert pt_et.main(["--trace", _TRAIN_ET, "--device", "cpu", "--mode",
                       "full", "--backend", "mock", "--max-ops", "20"]) == 0
    assert "executed 20 ops" in capsys.readouterr().out


def _details(path):
    records = [{"op_id": i, "comms": c, "size_bytes": 1 << 20,
                "lat_us": 10.0 + i, "marker": ""}
               for i, c in enumerate(["all_reduce", "all_gather",
                                      "all_reduce"])]
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def test_analyze_main(tmp_path, capsys):
    from param_tpu_torch.cli import analyze

    one = _details(str(tmp_path / "d0.json"))
    assert analyze.main([one, "--world-size", "2", "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert [r["collective"] for r in res["collectives"]] == [
        "all_gather", "all_reduce"]
    assert res["total_comm_us"] == pytest.approx(33.0)
    assert analyze.main([one, "--world-size", "2"]) == 0
    assert "all_reduce" in capsys.readouterr().out
    two = _details(str(tmp_path / "d1.json"))
    assert analyze.main([one, two, "--world-size", "2"]) == 0
    assert json.loads(capsys.readouterr().out)
    with pytest.raises(SystemExit):
        analyze.build_parser().parse_args(["x.json"])  # --world-size needed


def test_scaling_main(tmp_path, capsys):
    from param_tpu_torch.cli import scaling

    assert scaling.main(["--collective", "all_reduce", "--size", "64M",
                         "--worlds", "2", "4", "8", "16", "64",
                         "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["world"] for r in rows] == [2, 4, 8, 16, 64]
    assert [r["nodes"] for r in rows][-2:] == ["8*2n", "8*8n"]
    assert all(0 < r["bus_bw_gbs"] <= 450 for r in rows)
    assert scaling.main(["--collective", "all_to_all", "--worlds", "8",
                         "--nvlink-gbs", "100"]) == 0
    assert "all_to_all size=64M gen=h100" in capsys.readouterr().out
    trace = str(tmp_path / "comms.json")
    with open(trace, "w") as f:
        json.dump([{"comms": "all_reduce", "in_msg_size": 1 << 20,
                    "out_msg_size": 1 << 20, "dtype": "float32"}], f)
    assert scaling.main(["--trace-path", trace, "--worlds", "8", "16"]) == 0
    out = capsys.readouterr().out
    assert "per-op breakdown at world=8" in out and "8*2n" in out
    assert scaling.main([]) == 2
    with pytest.raises(SystemExit):
        scaling.build_parser().parse_args(["--generation", "v5e"])
