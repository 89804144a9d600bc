"""Guards of the port's boundaries: ``src/repro_torch``, ``chip_smoke.py``
and ``tools/`` import neither JAX nor the JAX package, importing the
trainer loads no JAX, and the entry points refuse to run quietly on the CPU
when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("src/repro_torch/train/trainer.py",
                 "src/repro_torch/kernels/ops.py", "chip_smoke.py",
                 "src/repro_torch/kernels/corr.py",
                 "src/repro_torch/core/omp.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/models/lm.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/ffn.py",
                 "src/repro_torch/data/tokens.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/gemma_2b.py",
                 "src/repro_torch/checkpoint/checkpoint.py",
                 "src/repro_torch/checkpoint/solver_state.py",
                 "src/repro_torch/resilience/faults.py",
                 "src/repro_torch/resilience/circuit.py",
                 "src/repro_torch/resilience/degrade.py",
                 "src/repro_torch/core/decremental.py",
                 "src/repro_torch/continual/buffer.py",
                 "src/repro_torch/artifacts/__init__.py",
                 "src/repro_torch/artifacts/store.py",
                 "src/repro_torch/artifacts/verify.py",
                 "src/repro_torch/artifacts/build.py",
                 "src/repro_torch/serve/__init__.py",
                 "src/repro_torch/serve/admission.py",
                 "src/repro_torch/serve/sessions.py",
                 "src/repro_torch/serve/registry.py",
                 "src/repro_torch/serve/scheduler.py",
                 "src/repro_torch/serve/service.py",
                 "src/repro_torch/serve/loadgen.py",
                 "src/repro_torch/launch/build_artifacts.py",
                 "src/repro_torch/launch/serve_selection.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/train/compression.py",
                 "src/repro_torch/optim/optimizers.py"):
        assert must in names


def test_port_imports_no_ml_dtypes():
    """The card's machine has no ``ml_dtypes``: bf16 checkpoints go
    through tensor views."""
    for path in PORT_FILES:
        assert "ml_dtypes" not in {m.split(".")[0] for m in _imports(path)}, (
            path)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_trainer_import_loads_no_jax():
    code = ("import sys; import repro_torch.train.trainer; "
            "import repro_torch.kernels.ops; "
            "import repro_torch.launch.train; "
            "import repro_torch.serve, repro_torch.artifacts; "
            "import repro_torch.launch.serve_selection; "
            "import repro_torch.launch.build_artifacts; "
            "import repro_torch.launch.serve, repro_torch.optim; "
            "import repro_torch.train.compression; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('ok')")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.configs.paper import mlp
    from repro_torch.data.synthetic import make_classification
    from repro_torch.train.trainer import AdaptiveTrainer, TrainerConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_classification(n=16, dim=4)
    ds = make_classification(n=16, dim=4, num_classes=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveTrainer(mlp(in_dim=4, num_classes=2), TrainerConfig(), ds, ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveTrainer(mlp(in_dim=4, num_classes=2),
                        TrainerConfig(checkpoint_dir="unused"), ds, ds)
    # asked for explicitly, the CPU is fine
    AdaptiveTrainer(mlp(in_dim=4, num_classes=2), TrainerConfig(), ds, ds,
                    device="cpu")


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_streaming_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import numpy as np

    from repro_torch.core import streaming

    g = np.ones((16, 3), np.float32)
    chunks = streaming.array_chunks(g, 8)
    for call in (lambda: streaming.omp_select_streaming(chunks, g.sum(0), 2),
                 lambda: streaming.gradmatch_streaming(chunks, 2),
                 lambda: streaming.streaming_target(chunks),
                 lambda: streaming.gradmatch_streaming_array(g, 2),
                 lambda: streaming.ChunkCache(1 << 10, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU is fine
    out = streaming.omp_select_streaming(chunks, g.sum(0), 2, device="cpu")
    assert out.indices.device.type == "cpu"


def test_partition_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import numpy as np

    from repro_torch.core import distributed, partition

    g = np.ones((16, 3), np.float32)
    parts, valids = g.reshape(2, 8, 3), np.ones((2, 8), bool)
    for call in (lambda: partition.gradmatch_partitioned(g, 2),
                 lambda: partition.gradmatch_partitioned_stream(pool=g, k=2),
                 lambda: distributed.sharded_omp_select(g, g.sum(0), 2),
                 lambda: distributed.sharded_gradmatch_pb(g, 4, 2),
                 lambda: distributed.fl_greedy_pmap(g, 2),
                 lambda: distributed.shard_fl_pool(g),
                 lambda: distributed.pmap_partition_omp(parts, g[:2], valids,
                                                        2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU is fine
    out = partition.gradmatch_partitioned(g, 2, device="cpu")
    assert out.indices.device.type == "cpu"


def test_continual_entry_points_refuse_the_cpu_without_being_asked(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import numpy as np

    from repro_torch.continual import BufferMaintainer, continual_select
    from repro_torch.resilience.degrade import stochastic_pool_select

    g = np.ones((16, 3), np.float32)
    for call in (lambda: BufferMaintainer(8, 3, g.sum(0), 2),
                 lambda: continual_select(g, 2),
                 lambda: stochastic_pool_select(g, g.sum(0), 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    m = BufferMaintainer(8, 3, g.sum(0), 2, device="cpu",
                         checkpoint_dir=str(tmp_path))
    m.admit(g[:4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BufferMaintainer.restore(str(tmp_path))
    # asked for explicitly, the CPU is fine
    assert continual_select(g, 2, device="cpu").indices.device.type == "cpu"
    assert BufferMaintainer.restore(str(tmp_path), device="cpu").batches == 1


def test_lm_driver_refuses_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenStream, token_batch
    from repro_torch.launch import train
    from repro_torch.models import lm

    for call in (lambda: train.main(["--smoke", "--steps", "1"]),
                 lambda: lm.init_lm(get_smoke_config("gemma-2b")),
                 lambda: TokenStream(0, 2, 8, 96),
                 lambda: token_batch(0, 0, 0, 2, 8, 96)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU is fine
    rep = train.main(["--smoke", "--steps", "1", "--window", "2",
                      "--micro-batch", "1", "--seq-len", "4", "--device",
                      "cpu"])
    assert rep["device"] == "cpu"


def test_lm_serving_refuses_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import attention, lm

    cfg = get_smoke_config("gemma2-9b")
    argv = ["--smoke", "--requests", "1", "--batch", "1", "--prompt-len",
            "4", "--gen-len", "1"]
    for call in (lambda: serve.main(argv),
                 lambda: lm.init_decode_state(cfg, 1, 8),
                 lambda: attention.init_decode_cache(cfg, 1, 8, window=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for explicitly, the CPU is fine
    assert serve.main(argv + ["--device", "cpu"])["tokens"] == 1


def test_optimizer_and_compression_state_follow_the_parameters():
    """AdamW's slots and the EF-TopK residuals live where the parameters
    do (here the meta device: no memory), never on a quiet CPU copy."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.steps import init_compression_state

    model = lm.init_lm(get_smoke_config("gemma-2b"), device="meta")
    opt = adamw(model.parameters(), 1e-3)
    opt.step(grads={p: torch.ones_like(p) for p in model.parameters()})
    for p in model.parameters():
        assert opt.state[p]["m"].device.type == "meta"
        assert opt.state[p]["v"].device.type == "meta"
    state = init_compression_state(model)
    assert {r.device.type for r in state.residual.values()} == {"meta"}


def test_serving_entry_points_refuse_the_cpu_without_being_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import numpy as np

    from repro_torch.artifacts import ArtifactStore, build_artifact
    from repro_torch.launch import build_artifacts, serve_selection
    from repro_torch.serve import PoolRegistry, SelectionService

    g = np.ones((16, 3), np.float32)
    store = ArtifactStore(str(tmp_path / "store"))
    for call in (lambda: SelectionService(),
                 lambda: PoolRegistry(),
                 lambda: build_artifact(store, g, g.sum(0), 2),
                 lambda: serve_selection.main(["--smoke"]),
                 lambda: serve_selection.main(["--load"]),
                 lambda: build_artifacts.main(
                     ["--smoke", "--store", str(tmp_path / "s")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.path.exists(tmp_path / "s")
    # asked for explicitly, the CPU is fine
    svc = SelectionService(device="cpu")
    assert svc.select(svc.register_pool(g), 2).indices.device.type == "cpu"
    key, _ = build_artifact(store, g, g.sum(0), 2, device="cpu")
    assert store.get(key) is not None
