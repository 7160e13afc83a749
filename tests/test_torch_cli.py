"""The port's DLRM trainer CLI on the CPU, and the rules of the port's package:
no JAX and nothing of the reference package, and no silent CPU fallback."""

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
                  "tests/torch_et_worker.py"]


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
