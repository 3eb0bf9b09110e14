"""Multi-host scan without a cluster (SURVEY.md §4): two OS processes on
localhost via jax.distributed loopback, CPU backend.  Process 0's output
files must be byte-identical to the committed oracle goldens (and hence
to a single-host run) — proving shard/gather/merge determinism — and a
re-run from the checkpoint directory must reproduce them without
rescanning.
"""

import filecmp
import os
import socket
import subprocess
import sys

import pytest

from conftest import ORACLE, REPO

GOLDEN = os.path.join(ORACLE, "golden", "meg3_sub3")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nproc: int, tmp_path, ckpt: str | None):
    port = _free_port()
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    procs = []
    for pid in range(nproc):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": REPO,
            "FASIM_COORD": f"127.0.0.1:{port}",
            "FASIM_NPROC": str(nproc),
            "FASIM_PID": str(pid),
        })
        if ckpt:
            env["FASIM_CKPT"] = ckpt
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fasim_tpu.dist.runner",
             "-f1", "meg3sub3.fa", "-f2", "MEG3.fa", "-O", "out/"],
            cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [pr.communicate(timeout=600)[0] for pr in procs]
    for pr, text in zip(procs, outs):
        assert pr.returncode == 0, text.decode()[-2000:]
    return out


def _assert_golden(outdir):
    expected = sorted(f for f in os.listdir(GOLDEN) if f != "stdout.txt")
    assert sorted(os.listdir(outdir)) == expected
    for name in expected:
        assert filecmp.cmp(outdir / name, os.path.join(GOLDEN, name),
                           shallow=False), f"{name} differs"


@pytest.mark.parametrize("nproc", [2])
def test_multihost_loopback_byte_identical(tmp_path, nproc):
    import shutil

    shutil.copy(os.path.join(ORACLE, "meg3sub3.fa"), tmp_path)
    shutil.copy(os.path.join(ORACLE, "MEG3.fa"), tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = _launch(nproc, tmp_path, ckpt)
    _assert_golden(out)
    # resume: wipe outputs, rerun from the checkpoint spills only
    for f in os.listdir(out):
        os.unlink(out / f)
    assert any(f.endswith(".pkl") for f in os.listdir(ckpt))
    out = _launch(nproc, tmp_path, ckpt)
    _assert_golden(out)
