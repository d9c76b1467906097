"""The port's entry points (fedml_tpu_torch/cli.py, __main__.py,
utils/metrics.py::RunLogger, utils/context.py, the package re-exports and
the pytree helpers) against the JAX package's.

* tests/test_cli.py's 18 functions, against the port's `main` with
  `--device cpu`: every ALGORITHMS value smoked (the table checked
  exhaustive), the mesh, streaming, block-stream, batch-axis, stack-dtype,
  unroll, augment, checkpoint and deployment flags.  One process is a
  mesh of one rank, so `--mesh_batch` runs at 1 and is refused by name
  when it does not divide the world.
* Parity with the JAX CLI on the same argv (LR on the MNIST stand-in, the
  port starting from JAX's init): fedavg, fedopt, hierarchical and
  fedavg_robust --defense median; every summary.json metric within rtol
  1e-4 / atol 1e-5 (f32 summation-order noise over 2 rounds; the
  accuracies are counts over the same samples and agree exactly).
* The parser takes every flag of fedml_tpu.cli.build_parser with its
  default, plus --device; without --device the CLI raises on a machine
  without a card.
* `--multihost_procs 2 --mesh --agg_blocks 2` (the self-spawned cluster)
  logs the one-process `--mesh --agg_blocks 2` summary exactly.
* RunLogger's files, graceful_abort and the sweep pipe; the pytree
  helpers against JAX's; the re-exported names against JAX's `__all__`.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.cli import main
from tests.test_torch_transports import free_base_port

REPO = Path(__file__).resolve().parents[1]

COMMON = ["--synthetic_scale", "0.001", "--client_num_in_total", "4",
          "--client_num_per_round", "4", "--comm_round", "2",
          "--batch_size", "4", "--frequency_of_the_test", "1"]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _summary(root, project="fedml_tpu_torch", name="t"):
    with open(os.path.join(root, project, name, "summary.json")) as f:
        return json.load(f)


def run_cli(tmp_path, *extra):
    rc = main([*COMMON, "--run_dir", str(tmp_path), "--run_name", "t",
               "--device", "cpu", *extra])
    assert rc == 0
    return _summary(tmp_path)


def test_cli_fedavg_mnist(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--lr", "0.1")
    assert "test_acc" in s
    hist = (tmp_path / "fedml_tpu_torch" / "t" / "history.jsonl")
    lines = [json.loads(x) for x in hist.read_text().splitlines()]
    assert [x["_step"] for x in lines] == [0, 1]   # every evaluated round
    cfg = json.loads((tmp_path / "fedml_tpu_torch" / "t"
                      / "config.json").read_text())
    assert cfg["device"] == "cpu" and cfg["algorithm"] == "fedavg"


def test_cli_fedopt(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "fedopt", "--dataset", "mnist",
                "--model", "lr", "--server_optimizer", "adam",
                "--server_lr", "0.01")
    assert "test_acc" in s


def test_cli_hierarchical(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "hierarchical", "--dataset",
                "mnist", "--model", "lr", "--group_num", "2")
    assert "test_acc" in s


def test_cli_vfl(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "vfl", "--dataset", "lending_club")
    assert "train_acc" in s


_ALGO_FLAGS = {
    "fedavg": ["--dataset", "mnist", "--model", "lr"],
    "fedopt": ["--dataset", "mnist", "--model", "lr",
               "--server_optimizer", "adam", "--server_lr", "0.01"],
    "fedprox": ["--dataset", "mnist", "--model", "lr", "--prox_mu", "0.1"],
    "fednova": ["--dataset", "mnist", "--model", "lr"],
    "fedavg_robust": ["--dataset", "mnist", "--model", "lr",
                      "--defense", "median"],
    "hierarchical": ["--dataset", "mnist", "--model", "lr",
                     "--group_num", "2"],
    "decentralized": ["--dataset", "susy", "--model", "lr",
                      "--topology", "ring"],
    "fednas": ["--dataset", "cifar10", "--nas_channels", "4",
               "--nas_layers", "2", "--nas_steps", "2",
               "--nas_multiplier", "2"],
    "fedgan": ["--dataset", "mnist"],
    "fedgkt": ["--dataset", "cifar10"],
    "splitnn": ["--dataset", "mnist"],
    "fedseg": ["--dataset", "pascal_voc", "--loss_type", "focal",
               "--lr_scheduler", "poly"],
    "turboaggregate": ["--dataset", "mnist", "--model", "lr"],
    "centralized": ["--dataset", "mnist", "--model", "lr"],
    "vfl": ["--dataset", "lending_club"],
}


@pytest.mark.parametrize("algo", sorted(_ALGO_FLAGS))
def test_cli_algorithm_smoke(tmp_path, algo):
    from fedml_tpu_torch.cli import ALGORITHMS
    assert algo in ALGORITHMS
    s = run_cli(tmp_path, "--algorithm", algo, *_ALGO_FLAGS[algo])
    assert s  # at least one metric logged


def test_cli_algorithm_table_is_exhaustive():
    from fedml_tpu.cli import ALGORITHMS as JAX_ALGORITHMS
    from fedml_tpu_torch.cli import ALGORITHMS
    assert sorted(_ALGO_FLAGS) == sorted(ALGORITHMS)
    assert ALGORITHMS == JAX_ALGORITHMS


def test_cli_fedgkt_mesh_dispatch():
    """--mesh + fedgkt selects MeshFedGKTEngine and forwards an explicit
    --server_* value."""
    from fedml_tpu_torch.algorithms.fedgkt import MeshFedGKTEngine
    from fedml_tpu_torch.cli import build_engine, build_parser
    from fedml_tpu_torch.data import load_data
    from fedml_tpu_torch.utils.config import FedConfig
    args = build_parser().parse_args(
        ["--algorithm", "fedgkt", "--dataset", "cifar10", "--mesh",
         "--client_num_in_total", "4", "--client_num_per_round", "4",
         "--batch_size", "8", "--synthetic_scale", "0.002",
         "--server_momentum", "0.0", "--device", "cpu"])
    cfg = FedConfig.from_args(args)
    data = load_data("cifar10", client_num_in_total=4, batch_size=8,
                     synthetic_scale=0.002)
    eng = build_engine(args, cfg, data)
    assert isinstance(eng, MeshFedGKTEngine)
    assert eng.server_tx is not None and eng.server_tx.momentum == 0.0
    assert eng._real_clients == 4 and eng.mesh.size == 1


def test_cli_streaming_mesh(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--mesh", "--streaming",
                "--cohort_chunk", "2", "--local_dtype", "bfloat16")
    assert s


def test_cli_fednova_mesh(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "fednova", "--dataset", "mnist",
                "--model", "lr", "--mesh")
    assert s


def test_cli_stream_block_mesh(tmp_path):
    # 20 sampled clients pad to 24 lanes: three 8-client blocks a round
    s = run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--mesh", "--stream_block", "8",
                "--client_num_in_total", "20",
                "--client_num_per_round", "20")
    assert "test_acc" in s


def test_cli_mesh_batch(tmp_path):
    # one process is a world of one rank: a (1 x 1) clients x batch mesh,
    # the plain --mesh round bitwise
    s = run_cli(tmp_path / "b", "--algorithm", "fedavg", "--dataset",
                "mnist", "--model", "lr", "--mesh", "--mesh_batch", "1")
    m = run_cli(tmp_path / "m", "--algorithm", "fedavg", "--dataset",
                "mnist", "--model", "lr", "--mesh")
    assert "test_acc" in s
    for k in ("test_acc", "test_loss", "train_loss"):
        assert s[k] == m[k], k


def test_cli_mesh_batch_requires_mesh_and_family(tmp_path):
    with pytest.raises(SystemExit):
        run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--mesh_batch", "2")
    with pytest.raises(SystemExit):
        run_cli(tmp_path, "--algorithm", "decentralized", "--dataset",
                "mnist", "--model", "lr", "--mesh", "--mesh_batch", "2")
    with pytest.raises(SystemExit, match="divide the batch size"):
        _refuse_batch_size(tmp_path)
    # one process: a 2-way batch axis does not divide the world, by name
    with pytest.raises(SystemExit, match="must divide the rank count"):
        run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--mesh", "--mesh_batch", "2")


def _refuse_batch_size(tmp_path):
    """The batch-size check, reached in a world the axis divides (one
    process, axis 1, is always divided: shape the world as 2 ranks)."""
    from fedml_tpu_torch.parallel import mesh as tmesh
    orig = tmesh.world
    tmesh.world = lambda: (2, 0)
    try:
        run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--mesh", "--mesh_batch", "2",
                "--batch_size", "15")
    finally:
        tmesh.world = orig


def test_cli_stack_dtype_flag(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
                "--model", "lr", "--lr", "0.1", "--mesh", "--streaming",
                "--stack_dtype", "bfloat16")
    assert "test_acc" in s
    with pytest.raises(SystemExit):      # requires --mesh
        run_cli(tmp_path / "e", "--algorithm", "fedavg", "--dataset",
                "mnist", "--model", "lr", "--stack_dtype", "bfloat16")
    # uint8: the loader stores the stack quantized and the engine
    # dequantizes on the device; the run still trains
    s = run_cli(tmp_path / "u8", "--algorithm", "fedavg", "--dataset",
                "mnist", "--model", "lr", "--lr", "0.1", "--mesh",
                "--streaming", "--stack_dtype", "uint8")
    assert "test_acc" in s


def test_cli_stack_dtype_rejects_unknown():
    from fedml_tpu_torch.cli import _stack_dtype
    assert _stack_dtype(argparse.Namespace(stack_dtype=None)) is None
    assert _stack_dtype(argparse.Namespace(stack_dtype="float32")) is None
    assert _stack_dtype(
        argparse.Namespace(stack_dtype="uint8")) == torch.uint8
    assert _stack_dtype(
        argparse.Namespace(stack_dtype="bfloat16")) == torch.bfloat16
    with pytest.raises(SystemExit, match="stack_dtype"):
        _stack_dtype(argparse.Namespace(stack_dtype="float16"))


def test_cli_batch_unroll_flag(tmp_path):
    """--batch_unroll drives only the JAX package's batch scan: the port
    accepts it (checked >= 1) and trains the same bits."""
    s1 = run_cli(tmp_path / "u1", "--algorithm", "fedavg", "--dataset",
                 "mnist", "--model", "lr", "--lr", "0.1")
    s2 = run_cli(tmp_path / "u2", "--algorithm", "fedavg", "--dataset",
                 "mnist", "--model", "lr", "--lr", "0.1",
                 "--batch_unroll", "2", "--no_flat_stack")
    assert s1["test_acc"] == s2["test_acc"]
    assert s1["test_loss"] == s2["test_loss"]
    with pytest.raises(SystemExit):
        run_cli(tmp_path / "u0", "--algorithm", "fedavg", "--dataset",
                "mnist", "--model", "lr", "--batch_unroll", "0")


def test_cli_augment_flag(tmp_path):
    s = run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "cifar10",
                "--model", "cnn", "--augment")
    assert s


def _native_available():
    from fedml_tpu_torch.native import load_library
    try:
        return load_library() is not None
    except Exception:
        return False


@pytest.mark.parametrize(
    "backend",
    ["TCP", "GRPC",
     pytest.param("NATIVE_TCP", marks=pytest.mark.skipif(
         not _native_available(), reason="native transport not buildable"))])
def test_two_process_deployment(tmp_path, backend):
    """A real server and two client processes over localhost sockets (the
    reference's run_fedavg_grpc.sh deployment)."""
    if backend == "GRPC":
        pytest.importorskip("grpc")
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    port = free_base_port(3)
    common = [sys.executable, "-m", "fedml_tpu_torch",
              "--algorithm", "fedavg", "--dataset", "mnist", "--model", "lr",
              "--synthetic_scale", "0.002", "--client_num_in_total", "2",
              "--client_num_per_round", "2", "--comm_round", "1",
              "--batch_size", "4", "--world_size", "3",
              "--comm_backend", backend, "--base_port", str(port),
              "--run_dir", str(tmp_path), "--device", "cpu"]
    server = subprocess.Popen(common + ["--deploy", "server", "--rank", "0",
                                        "--run_name", "srv"], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
    clients = [subprocess.Popen(common + ["--deploy", "client",
                                          "--rank", str(r),
                                          "--run_name", f"c{r}"], env=env,
                                cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
               for r in (1, 2)]
    try:
        _out, err = server.communicate(timeout=240)
        assert server.returncode == 0, err.decode()[-2000:]
        for c in clients:
            c.communicate(timeout=60)
            assert c.returncode == 0
        summary = _summary(tmp_path, name="srv")
        assert summary["rounds"] == 1
        assert 0.0 <= summary["test_acc"] <= 1.0
    finally:
        for p in [server] + clients:
            if p.poll() is None:
                p.kill()


def test_cli_checkpointing(tmp_path):
    full = run_cli(tmp_path / "full", "--algorithm", "fedavg", "--dataset",
                   "mnist", "--model", "lr", "--comm_round", "3")
    run_cli(tmp_path, "--algorithm", "fedavg", "--dataset", "mnist",
            "--model", "lr", "--ckpt_dir", str(tmp_path / "ck"),
            "--ckpt_every", "1")
    assert os.path.isdir(tmp_path / "ck")
    s = run_cli(tmp_path / "r", "--algorithm", "fedavg", "--dataset",
                "mnist", "--model", "lr", "--ckpt_dir", str(tmp_path / "ck"),
                "--resume", "--comm_round", "3")
    # the resumed run continues the uninterrupted one bitwise
    assert s["round"] == 2
    for k in ("test_acc", "test_loss", "train_loss"):
        assert s[k] == full[k], k


# ---------------------------------------------------------------------------
# the JAX CLI on the same argv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,flags", [
    ("fedavg", ["--lr", "0.1"]),
    ("fedopt", ["--server_optimizer", "adam", "--server_lr", "0.01"]),
    ("hierarchical", ["--group_num", "2"]),
    ("fedavg_robust", ["--defense", "median"]),
])
def test_cli_matches_the_jax_cli(tmp_path, monkeypatch, algo, flags):
    from fedml_tpu import cli as jcli
    from fedml_tpu.data import load_data as jload
    from fedml_tpu.utils.config import FedConfig as JaxFedConfig
    from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
    from fedml_tpu_torch.convert import flax_to_torch
    argv = [*COMMON, "--algorithm", algo, "--dataset", "mnist", "--model",
            "lr", "--run_name", "t", *flags]
    assert jcli.main([*argv, "--run_dir", str(tmp_path / "jax")]) == 0
    want = _summary(tmp_path / "jax", project="fedml_tpu")
    # the port starts from JAX's init (the two packages draw their own)
    jargs = jcli.build_parser().parse_args(argv)
    jcfg = JaxFedConfig.from_args(jargs)
    jdata = jload("mnist", client_num_in_total=4, batch_size=4,
                  synthetic_scale=0.001)
    v0 = flax_to_torch(jax.tree.map(
        np.asarray, jcli.build_engine(jargs, jcfg, jdata).init_variables()))
    monkeypatch.setattr(FedAvgEngine, "init_variables",
                        lambda self, generator=None: {
                            k: v.clone().to(self.device)
                            for k, v in v0.items()})
    got = run_cli(tmp_path / "port", *argv[len(COMMON):])
    keys = sorted(k for k in want if k != "round_time")
    assert keys and sorted(k for k in got if k != "round_time") == keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_parser_takes_every_jax_flag_plus_device():
    from fedml_tpu.cli import build_parser as jax_parser
    from fedml_tpu_torch.cli import build_parser
    j = {a.dest: a for a in jax_parser()._actions}
    t = {a.dest: a for a in build_parser()._actions}
    assert set(t) - set(j) == {"device"}
    assert set(j) <= set(t)
    for dest, a in j.items():
        b = t[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert b.choices == a.choices, dest
        assert type(b) is type(a), dest
    assert t["device"].default is None


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([*COMMON, "--run_dir", str(tmp_path), "--algorithm", "fedavg",
              "--dataset", "mnist", "--model", "lr"])
    assert not (tmp_path / "fedml_tpu_torch").exists()


def test_cli_multihost_procs_logs_the_one_process_summary(tmp_path):
    """The self-spawned two-level cluster (one rank a member, 2 blocks)
    logs the one-process two-block run's summary exactly."""
    common = [*COMMON, "--client_num_in_total", "8",
              "--client_num_per_round", "8", "--algorithm", "fedavg",
              "--dataset", "mnist", "--model", "lr", "--lr", "0.1",
              "--mesh", "--agg_blocks", "2", "--device", "cpu",
              "--run_name", "t"]
    assert main([*common, "--run_dir", str(tmp_path / "one")]) == 0
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-m", "fedml_tpu_torch", *common,
                        "--multihost_procs", "2", "--run_dir",
                        str(tmp_path / "two")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    one = _summary(tmp_path / "one")
    two = _summary(tmp_path / "two")
    assert sorted(one) == sorted(two)
    for k in one:
        if k != "round_time":
            assert one[k] == two[k], k


# ---------------------------------------------------------------------------
# RunLogger, the context helpers, the re-exports, the pytree helpers
# ---------------------------------------------------------------------------

def test_run_logger_files(tmp_path):
    from fedml_tpu_torch.utils.metrics import RunLogger
    with RunLogger(root=str(tmp_path), project="p", name="n",
                   config={"a": 1}) as lg:
        lg.log({"test_acc": 0.5, "loss": torch.tensor(2.0)}, step=0)
        lg.log({"test_acc": 0.75}, step=1)
    d = tmp_path / "p" / "n"
    hist = [json.loads(x) for x in (d / "history.jsonl").read_text()
            .splitlines()]
    assert [h["_step"] for h in hist] == [0, 1]
    assert hist[0]["loss"] == 2.0
    assert RunLogger.read_summary(str(d)) == {"test_acc": 0.75, "loss": 2.0}
    assert json.loads((d / "config.json").read_text()) == {"a": 1}
    with pytest.raises(ValueError, match="closed"):
        lg.log({"x": 1})
    lg.finish()                                  # idempotent


def test_graceful_abort_and_sweep_pipe(tmp_path):
    from fedml_tpu_torch.utils.context import (
        graceful_abort, post_complete_message_to_sweep_process)

    class Mgr:
        finished = 0

        def finish(self):
            Mgr.finished += 1

    with pytest.raises(ValueError, match="boom"):
        with graceful_abort(Mgr(), Mgr()):
            raise ValueError("boom")
    assert Mgr.finished == 2
    with graceful_abort(Mgr(), reraise=False):
        raise KeyError("swallowed")
    with pytest.raises(KeyboardInterrupt):
        with graceful_abort(Mgr(), reraise=False):
            raise KeyboardInterrupt
    # no reader on the pipe: the message is dropped after the wait
    pipe = tmp_path / "sweep" / "fifo"
    post_complete_message_to_sweep_process({"a": 1}, pipe_path=str(pipe),
                                           wait_for_reader=0.1)
    assert pipe.exists()


def test_reexports_match_the_jax_package():
    import fedml_tpu
    import fedml_tpu.core as jcore
    import fedml_tpu_torch
    import fedml_tpu_torch.core as tcore
    assert fedml_tpu_torch.__version__ == fedml_tpu.__version__
    # the port's trainer carries no TrainState (its state is a flat vector
    # and an optimizer dict)
    assert sorted(tcore.__all__) == sorted(set(jcore.__all__)
                                           - {"TrainState"})
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name


def test_pytree_helpers_match_jax():
    from fedml_tpu.core import pytree as jp
    from fedml_tpu_torch.core import pytree as tp
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    b = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    st = tp.tree_stack([ta, tb])
    jst = jp.tree_stack([ja, jb])
    for k in a:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
    un = tp.tree_unstack(st)
    assert len(un) == 2
    for k in a:
        assert torch.equal(un[1][k], tb[k])
    z = tp.tree_zeros_like(ta)
    assert all(torch.count_nonzero(v) == 0 and v.shape == ta[k].shape
               for k, v in z.items())
    np.testing.assert_allclose(float(tp.tree_dot(ta, tb)),
                               float(jp.tree_dot(ja, jb)), rtol=1e-6)
    c = tp.tree_cast(ta, torch.bfloat16)
    jc = jp.tree_cast(ja, jnp.bfloat16)
    for k in a:
        np.testing.assert_array_equal(
            c[k].float().numpy(), np.asarray(jc[k].astype(jnp.float32)))
    # the flat vector: the JAX package's leaf order is sorted by key
    order = sorted(a)
    vec = tp.vectorize_weights({k: ta[k] for k in order})
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(jp.vectorize_weights(ja)))
    back = tp.unvectorize_weights(vec, {k: ta[k] for k in order})
    for k in a:
        assert torch.equal(back[k], ta[k])
    # the schedule's step count (the optimizer state's "count") advances
    # through all-padding steps; Adam's count and the moments stay
    kept = {"count": torch.tensor(1), "adam_count": torch.tensor(1),
            "mu": torch.zeros(2), "inner": {"count": torch.tensor(0)}}
    adv = {"count": torch.tensor(5), "adam_count": torch.tensor(5),
           "mu": torch.ones(2), "inner": {"count": torch.tensor(3)}}
    merged = tp.tree_merge_counts(kept, adv)
    assert int(merged["count"]) == 5 and int(merged["inner"]["count"]) == 3
    assert int(merged["adam_count"]) == 1
    assert torch.equal(merged["mu"], torch.zeros(2))


def test_import_scan_covers_the_entry_points():
    from tests.test_torch_fedavg import FORBIDDEN, _imported_modules
    for rel in ("cli.py", "__main__.py", "utils/context.py",
                "utils/metrics.py", "core/pytree.py", "__init__.py"):
        f = REPO / "fedml_tpu_torch" / rel
        assert f.exists(), rel
        assert not [m for m in _imported_modules(f)
                    if m.split(".")[0] in FORBIDDEN], rel
