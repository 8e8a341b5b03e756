"""npt-launch tests: local spawn wiring, slurm command construction, and
the SLURM env fallbacks in hosts.init_distributed."""
import subprocess
import sys

import nextpolish_tpu.launch as launch
from nextpolish_tpu.parallel.hosts import _slurm_first_node


def test_local_spawn_sets_protocol_env(monkeypatch, tmp_path):
    """Each local rank gets NPT_COORDINATOR/NUM_PROCS/PROC_ID and the
    worker command; ranks are distinct."""
    seen = []

    class FakeProc:
        def wait(self):
            return 0

    def fake_popen(cmd, env=None, **kw):
        seen.append((cmd, env))
        return FakeProc()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    rc = launch.launch_local("run.cfg", 3, {"PATH": "/bin"})
    assert rc == 0
    assert len(seen) == 3
    coords = {env["NPT_COORDINATOR"] for _, env in seen}
    assert len(coords) == 1 and next(iter(coords)).startswith("127.0.0.1:")
    assert sorted(env["NPT_PROC_ID"] for _, env in seen) == ["0", "1", "2"]
    assert all(env["NPT_NUM_PROCS"] == "3" for _, env in seen)
    assert all(cmd[:3] == [sys.executable, "-m", "nextpolish_tpu"]
               for cmd, _ in seen)


def test_local_ranks_get_one_gpu_each(monkeypatch):
    """Local rank r sees only the r-th visible card, so no two JAX
    processes reserve the same GPU."""
    seen = []

    class FakeProc:
        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, env=None, **kw: seen.append(env)
                        or FakeProc())
    launch.launch_local("run.cfg", 2, {"PATH": "/bin"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in seen] == ["0", "1"]
    seen.clear()
    launch.launch_local("run.cfg", 2, {"CUDA_VISIBLE_DEVICES": "5,7"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in seen] == ["5", "7"]
    import pytest

    with pytest.raises(ValueError):
        launch.local_rank_env(2, 3, {"CUDA_VISIBLE_DEVICES": "0,1"})


def test_slurm_command(monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, env=None: calls.append((cmd, env)) or 0)
    launch.launch_slurm("run.cfg", 2, {})
    (cmd, env), = calls
    assert cmd[:5] == ["srun", "--ntasks", "2", "--ntasks-per-node", "1"]
    assert env["NPT_NUM_PROCS"] == "2"


def test_slurm_first_node():
    assert _slurm_first_node("node-a,node-b") == "node-a"
    assert _slurm_first_node("node[003-010]") == "node003"
    assert _slurm_first_node("n[7,9]") == "n7"


def test_cli_requires_a_mode(capsys):
    import pytest

    with pytest.raises(SystemExit):
        launch.main(["run.cfg"])
