"""The port's example drivers (``repro_torch.examples``) run end to end on
the CPU: ``quickstart`` at its own size (8 clients of 150 samples),
``federated_nas_cifar`` at one generation of 4 clients of 100 samples
(``fed_nas.build_clients`` with a smaller ``n``), ``serve_batched`` at
its defaults (smoke configs).  No JAX run: the modules they drive have
parity tests of their own."""
import functools
import json

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest workers at once,
# and at these sizes more threads only contend for the cores
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.examples import fed_nas, federated_nas_cifar, \
    quickstart, serve_batched  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SMALL = ["--device", "cpu", "--generations", "1", "--clients", "4",
         "--population", "2", "--offline-generations", "1"]


@pytest.fixture
def small_clients(monkeypatch):
    """``federated_nas_cifar`` builds its clients from 400 samples."""
    monkeypatch.setattr(fed_nas, "build_clients",
                        functools.partial(fed_nas.build_clients, n=400))


def test_quickstart_runs_on_the_cpu(capsys):
    hist = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Pareto front after 2 generations" in out
    assert "batched dispatches 8" in out          # fused vmap: 2 gens + 1
    assert hist["gen"] == [1, 2]
    assert np.isfinite(hist["objs"][-1]).all()
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_federated_nas_cifar_runs_on_the_cpu(tmp_path, capsys,
                                             small_clients):
    path = federated_nas_cifar.main(SMALL + ["--out", str(tmp_path)])
    assert path == str(tmp_path / "fednas_rt_torch_iid_c4.json")
    rec = json.loads((tmp_path / "fednas_rt_torch_iid_c4.json").read_text())
    assert rec["gen"] == [1] and rec["device"] == "cpu"
    assert rec["front"] and len(rec["final_objs"]) == 4
    assert len(rec["baseline_err"]) == 1 and rec["offline_gens"] == 1
    assert "offline ENAS baseline" in capsys.readouterr().out


@pytest.mark.parametrize("backend,exc", [("vmap", None), ("mesh", None)])
def test_federated_nas_cifar_engine_backends(tmp_path, backend, exc,
                                             small_clients):
    """Both batched backends run the example (``mesh`` on one CPU
    device); no backend raises."""
    argv = SMALL + ["--engine-backend", backend, "--out", str(tmp_path)]
    federated_nas_cifar.main(argv)
    rec = json.loads((tmp_path / "fednas_rt_torch_iid_c4.json").read_text())
    assert rec["gen"] == [1] and len(rec["final_objs"]) == 4


@pytest.mark.parametrize("argv", [[], ["--window", "16"],
                                  ["--arch", "mamba2-780m"]],
                         ids=["qwen", "qwen-window", "mamba2"])
def test_serve_batched_runs_on_the_cpu(argv, capsys):
    """Batched greedy generation at the defaults: 4 requests of 32
    prompt tokens and 24 new ones, the prompt kept, no kernel launched;
    ``--window 16`` decodes through a 16-slot ring."""
    toks = serve_batched.main(["--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert toks.shape == (4, 32 + 24)
    cfg = serve_batched.get_config(argv[1] if "--arch" in argv
                                   else "qwen1.5-0.5b", smoke=True)
    assert int(toks.max()) < cfg.vocab_size and int(toks.min()) >= 0
    assert ("cache_len=16, sliding" in out) == ("--window" in argv)
    assert "first request:" in out
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_default_device_is_cuda():
    """Without ``--device`` the drivers ask for the card, and raise
    where there is none (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batched.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fed_nas.run_rt(fed_nas.build_api(),
                       fed_nas.build_clients(4, n=400), 1, population=2)
