"""The port's process-group start and its sharded CLI: ``init_multihost``
returns False without a launcher's environment (as JAX's does without a
cluster) and initialises two ranks from one, and
``cli.sharded_train --device cpu`` trains under two gloo ranks in both
modes (graph sharding, and the 2-D subnet x graph mesh) with the JAX
CLI's result keys."""

import socket

import pytest

from torch_dist_workers import run_world

JAX_1D_KEYS = {"dataset", "model", "n_devices", "train_time",
               "edges_per_sec", "edges_per_sec_per_chip", "final_test_acc",
               "best_val_acc", "best_test_acc", "val_accs", "test_accs",
               "losses"}
JAX_2D_KEYS = {"dataset", "model", "mesh_2d", "n_devices", "iter_per_site",
               "train_time", "final_test_acc", "best_val_acc",
               "best_test_acc", "val_accs", "test_accs", "losses",
               "comm_per_step_layer0"}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_multihost_without_environment(monkeypatch):
    import torch.distributed as dist

    from gist_tpu_torch.multihost import init_multihost
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    assert init_multihost(device="cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        init_multihost("file:///nonexistent/rdv", device="cpu")


def test_init_multihost_two_ranks_from_launcher_env():
    res = run_world(2, [("mh", dict(fn="multihost"))],
                    {"port": _free_port()}, timeout_s=60,
                    init=False)["mh"]
    for bare, ok, world, total, again in res:
        assert (bare, ok, world, total, again) == (False, True, 2, 3.0,
                                                   False)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    common = ["--dataset", "synth-tiny", "--n-hidden", "8", "--device",
              "cpu", "--n-devices", "2"]
    cases = [
        ("sage", dict(fn="cli", argv=common + [
            "--model", "sage", "--n-epochs", "4",
            "--result-json", str(out / "sage.json")])),
        ("gcn_bf16", dict(fn="cli", argv=common + [
            "--model", "gcn", "--n-epochs", "4", "--halo-dtype",
            "bfloat16"])),
        ("gat", dict(fn="cli", argv=common + ["--model", "gat",
                                              "--n-epochs", "4"])),
        ("ist_2d", dict(fn="cli", argv=common + [
            "--model", "sage", "--ist-subnets", "2", "--n-epochs", "2",
            "--iter_per_site", "2"])),
    ]
    return run_world(2, cases, timeout_s=120), out


@pytest.mark.parametrize("case", ["sage", "gcn_bf16", "gat"])
def test_sharded_train_cli_two_ranks(cli_runs, case):
    runs, out = cli_runs
    r0, r1 = runs[case]
    assert set(r0) == JAX_1D_KEYS | {"interior_tiles"}
    assert r0["interior_tiles"] is False      # no layouts on the CPU
    assert r0["n_devices"] == 2 and len(r0["losses"]) == 4
    assert r0["losses"] == r1["losses"] and r0["val_accs"] == r1["val_accs"]
    assert all(l == l for l in r0["losses"])      # finite, not NaN
    assert r0["losses"][-1] < r0["losses"][0]
    if case == "sage":
        import json
        written = json.loads((out / "sage.json").read_text())
        assert written["losses"] == r0["losses"]
        assert written["hardware"] == "cpu"


def test_sharded_train_cli_2d_two_ranks(cli_runs):
    runs, _ = cli_runs
    r0, r1 = runs["ist_2d"]
    assert set(r0) == JAX_2D_KEYS | {"interior_tiles"}
    assert r0["mesh_2d"] == [2, 1] and r0["iter_per_site"] == 2
    assert r0["losses"] == r1["losses"] and r0["val_accs"] == r1["val_accs"]
    assert len(r0["losses"]) == 2


def test_sharded_train_cli_checks_world_size():
    from gist_tpu_torch.cli.sharded_train import main
    with pytest.raises(SystemExit, match="world size"):
        main(["--dataset", "synth-tiny", "--device", "cpu", "--n-devices",
              "2", "--n-epochs", "1"])


def test_dryrun_multichip_two_ranks(capsys):
    """The dry run asked for the CPU (``python -m gist_tpu_torch.dryrun N
    --device cpu``): an IST round and the three sharded steps on two
    gloo ranks."""
    from gist_tpu_torch.dryrun import dryrun_multichip
    res = dryrun_multichip(2, device="cpu")
    assert len(res["ist_round_losses"]) == 2 * 2
    out = capsys.readouterr().out
    assert "on cpu over gloo" in out and "graph-sharded steps ok" in out


def test_dryrun_defaults_to_the_card():
    """Without ``--device cpu`` the dry run asks for the card, and raises
    where there is none rather than run on the CPU."""
    import torch

    from gist_tpu_torch.dryrun import dryrun_multichip
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
