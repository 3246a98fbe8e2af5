"""Multi-host distributed runtime test (SURVEY.md §5 comm backend).

Spins up a REAL 2-process ``jax.distributed`` CPU cluster (local
coordinator, 4 virtual devices per process — no GPU cluster needed) and runs
``distributed_topk`` on a mesh spanning both processes, asserting equality
with the NumPy oracle in every process.  This executes the one distributed
code path the virtual single-process mesh cannot: ``init_distributed``
(parallel/mesh.py) and cross-process collectives (Gloo on CPU; NCCL across
GPU hosts — same XLA program).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    """Clean environment: the workers pick CPU and their own virtual
    device count themselves."""
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")
    }
    env["PYTHONPATH"] = _REPO
    return env


def test_two_process_distributed_topk():
    nproc = 2
    port = _free_port()
    env = _worker_env()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(nproc), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n"
                    + "\n---\n".join(o or "" for o in outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"worker {pid} exited {p.returncode}:\n{out[-4000:]}")
        assert "MULTIHOST_OK" in out, (
            f"worker {pid} never reached MULTIHOST_OK:\n{out[-4000:]}")
